// The two softmaxes of the cross-attention's shared similarity, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves gscream_tpu/ops/attention.py
// to XLA.  Added because PyTorch takes the context-side softmax, over dim -2
// of the row-major (h, N, M) similarity, with its strided
// cunn_SpatialSoftMaxForward/Backward, and runs the scale, the two masks,
// their backwards and the add of the two gradients as full passes of their
// own.
//
// What they compute (ops/attention.py: dual_softmax_plain and
// dual_softmax_bwd_plain are the plain versions), with MIN = finfo(float32).min
// and the masks m_i (rows, "mask") and cm_j (columns, "context_mask"), each
// true where absent:
//   s[h,i,j]    = cm_j ? scale * raw[h,i,j] : MIN
//   attn        = softmax over j of s
//   ctx_attn    = softmax over i of (m_i ? s : MIN)
//   grad[h,i,j] = cm_j ? scale * (A (gA - r_i) + (m_i ? C (gC - c_j) : 0)) : 0
//   r_i = sum_j gA A,   c_j = sum_i gC C
// A row or column masked everywhere comes out uniform, as in JAX (MIN, not
// -inf).  Every sum runs in one fixed order, so a rerun is bit-equal.
//
// Design.  Forward, three launches: col_stats (threads on consecutive
// columns, four each, loads of 16 bytes; the rows cut into chunks so that
// about eight CTAs a SM fill the card; an online (max, sum of exp) per column
// and chunk), col_merge (the chunks of each column in order: its max and the
// reciprocal of its sum) and row_write (one CTA a row: the row's max, its sum,
// then attn and ctx_attn written together; the row is read from device memory
// once, then twice from L1).  Backward, two launches: bwd_stats (c_j over
// 32-column strips, r_i one warp a row) and bwd_write (32 x 32 tiles, the sum
// of both gradients written once).  gC arrives as the transpose of a
// contiguous (h, M, N) array: the output einsum "hij,hid->hjd" contracts i,
// and its backward is one batched product into that layout.  Both backward
// kernels read it so, turning 32 x 32 tiles through shared memory, and no
// transposed copy is made.
//
// Bound on the H100: bytes.  At (8, 2000, 2000) each array is 128 MB.  The
// forward needs 384 MB (sim read once, attn and ctx_attn written; 0.115 ms at
// 3.35 TB/s) and moves 512 MB (sim twice: the column statistics, then the
// rows).  The backward needs 640 MB (A, C, gA, gC read, grad written; 0.19
// ms) and moves 1152 MB (the four inputs twice: r and c need whole rows and
// columns before any gradient is written, and 512 MB do not stay in the 50 MB
// L2).  The scratch (chunk statistics, r, c) is a few MB and stays in L2.
// expf, not __expf: each kernel is within a stated tolerance of its plain
// version (tests/test_torch_dual_softmax.py), not bit-equal.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr float kMin = -FLT_MAX;   // finfo(float32).min
constexpr int kColThreads = 128;   // col_stats: 512 columns a CTA
constexpr int kColCtasPerSm = 8;
constexpr int kRowThreads = 256;   // row_write: one row a CTA
constexpr int kMergeThreads = 256;
constexpr int kTile = 32;          // backward tiles
constexpr int kTileThreads = 256;  // 8 threads of four floats per tile row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float& at(float4& v, int k) {
  return (&v.x)[k];
}

// p[col .. col+3], zero from `limit` on.  kVec: col and limit are multiples
// of 4 and p is 16-byte aligned, so a float4 is wholly inside or outside.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int col,
                                        int limit) {
  if (kVec) {
    return col < limit ? __ldg(reinterpret_cast<const float4*>(p + col))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 v;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    at(v, k) = col + k < limit ? __ldg(p + col + k) : 0.f;
  }
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ p, int col,
                                       int limit, float4 v) {
  if (kVec) {
    if (col < limit) *reinterpret_cast<float4*>(p + col) = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (col + k < limit) p[col + k] = at(v, k);
  }
}

// the four column flags at col (true where the mask is absent)
__device__ __forceinline__ void flags4(const unsigned char* __restrict__ cm,
                                       int col, int limit, bool (&ok)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ok[k] = cm == nullptr || (col + k < limit && __ldg(cm + col + k) != 0);
  }
}

// one element into an online (max, sum of exp(x - max)); mx starts at -inf
__device__ __forceinline__ void online(float& mx, float& s, float x) {
  const float d = x - mx;
  const float e = expf(-fabsf(d));
  s = d > 0.f ? fmaf(s, e, 1.f) : s + e;
  mx = fmaxf(mx, x);
}

template <bool kVec>
__global__ void __launch_bounds__(kColThreads)
col_stats(const float* __restrict__ raw, const unsigned char* __restrict__ mask,
          const unsigned char* __restrict__ cmask, int n, int m, float scale,
          int rows_per_chunk, int chunks, float* __restrict__ pmax,
          float* __restrict__ psum) {
  const int h = blockIdx.z, chunk = blockIdx.y;
  const int j = (blockIdx.x * kColThreads + threadIdx.x) * 4;
  if (j >= m) return;
  const int i0 = chunk * rows_per_chunk;
  const int i1 = min(n, i0 + rows_per_chunk);
  bool cm[4];
  flags4(cmask, j, m, cm);
  float4 mx = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = raw + (size_t)h * n * m;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const bool mi = mask == nullptr || __ldg(mask + i) != 0;
    float4 v = load4<kVec>(p + (size_t)i * m, j, m);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      online(at(mx, k), at(s, k), mi && cm[k] ? at(v, k) * scale : kMin);
    }
  }
  const size_t o = ((size_t)h * chunks + chunk) * m;
  store4<kVec>(pmax + o, j, m, mx);
  store4<kVec>(psum + o, j, m, s);
}

__global__ void __launch_bounds__(kMergeThreads)
col_merge(const float* __restrict__ pmax, const float* __restrict__ psum,
          int h_count, int m, int chunks, float* __restrict__ cmax,
          float* __restrict__ cinv) {
  const int t = blockIdx.x * kMergeThreads + threadIdx.x;
  if (t >= h_count * m) return;
  const int h = t / m, j = t - h * m;
  const size_t base = (size_t)h * chunks * m + j;
  float mx = pmax[base], s = psum[base];
  for (int c = 1; c < chunks; ++c) {
    const float m2 = pmax[base + (size_t)c * m], s2 = psum[base + (size_t)c * m];
    const float mm = fmaxf(mx, m2);
    s = s * expf(mx - mm) + s2 * expf(m2 - mm);
    mx = mm;
  }
  cmax[t] = mx;
  cinv[t] = 1.f / s;
}

// op over the CTA of kRowThreads threads; every thread gets the result
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float o = __shfl_xor_sync(kFull, v, d);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red's previous use is read
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w) {
    v = kMax ? fmaxf(v, red[w]) : v + red[w];
  }
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kRowThreads)
row_write(const float* __restrict__ raw, const unsigned char* __restrict__ mask,
          const unsigned char* __restrict__ cmask, int n, int m, float scale,
          const float* __restrict__ cmax, const float* __restrict__ cinv,
          float* __restrict__ attn, float* __restrict__ ctx) {
  __shared__ float red[kRowThreads / 32];
  const int row = blockIdx.x;  // h * n + i
  const int h = row / n, i = row - h * n;
  const bool mi = mask == nullptr || __ldg(mask + i) != 0;
  const size_t off = (size_t)row * m;
  const float* p = raw + off;
  const int step = kRowThreads * 4;

  float mx = -INFINITY;
  for (int j = threadIdx.x * 4; j < m; j += step) {
    float4 v = load4<kVec>(p, j, m);
    bool cm[4];
    flags4(cmask, j, m, cm);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j + k < m) mx = fmaxf(mx, cm[k] ? at(v, k) * scale : kMin);
    }
  }
  mx = block_reduce<true>(mx, red);

  float s = 0.f;
  for (int j = threadIdx.x * 4; j < m; j += step) {
    float4 v = load4<kVec>(p, j, m);
    bool cm[4];
    flags4(cmask, j, m, cm);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j + k < m) s += expf((cm[k] ? at(v, k) * scale : kMin) - mx);
    }
  }
  s = block_reduce<false>(s, red);
  const float inv = 1.f / s;

  const float* cmx = cmax + (size_t)h * m;
  const float* civ = cinv + (size_t)h * m;
  for (int j = threadIdx.x * 4; j < m; j += step) {
    float4 v = load4<kVec>(p, j, m);
    float4 cx = load4<kVec>(cmx, j, m);
    float4 ci = load4<kVec>(civ, j, m);
    bool cm[4];
    flags4(cmask, j, m, cm);
    float4 a, c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x = cm[k] ? at(v, k) * scale : kMin;
      at(a, k) = expf(x - mx) * inv;
      at(c, k) = expf((mi ? x : kMin) - at(cx, k)) * at(ci, k);
    }
    store4<kVec>(attn + off, j, m, a);
    store4<kVec>(ctx + off, j, m, c);
  }
}

// Blocks [0, strips): c_j of 32 columns each, down all rows; tile rows of C
// are read along j, of gCt along i, and meet in shared memory.  Blocks from
// `strips` on: r_i, one warp a row.
template <bool kVec>
__global__ void __launch_bounds__(kTileThreads)
bwd_stats(const float* __restrict__ A, const float* __restrict__ gA,
          const float* __restrict__ C, const float* __restrict__ gCt,
          int h_count, int n, int m, int strips, float* __restrict__ r,
          float* __restrict__ c) {
  __shared__ float sC[kTile][kTile + 1];
  const int t = threadIdx.x;
  if (blockIdx.x < strips) {
    const int j_tiles = (m + kTile - 1) / kTile;
    const int h = blockIdx.x / j_tiles;
    const int j0 = (blockIdx.x - h * j_tiles) * kTile;
    const int li = t >> 3, lj = (t & 7) * 4;  // C: row li, columns lj..+3
    const int jj = t >> 3, ii = (t & 7) * 4;  // gCt: column jj, rows ii..+3
    const float* Ch = C + (size_t)h * n * m;
    const float* Gt = gCt + ((size_t)h * m + j0 + jj) * n;
    const bool jin = j0 + jj < m;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 cv = li < n ? load4<kVec>(Ch + (size_t)li * m, j0 + lj, m) : zero;
    float4 gv = jin ? load4<kVec>(Gt, ii, n) : zero;
    float acc = 0.f;
    for (int i0 = 0; i0 < n; i0 += kTile) {
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k) sC[li][lj + k] = at(cv, k);
      __syncthreads();
      float4 g = gv;
      const int i1 = i0 + kTile;
      if (i1 < n) {
        cv = i1 + li < n ? load4<kVec>(Ch + (size_t)(i1 + li) * m, j0 + lj, m)
                         : zero;
        gv = jin ? load4<kVec>(Gt, i1 + ii, n) : zero;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = fmaf(at(g, k), sC[ii + k][jj], acc);
    }
    // the 8 lanes of one column are neighbours in a warp
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    acc += __shfl_xor_sync(kFull, acc, 4);
    if ((t & 7) == 0 && jin) c[(size_t)h * m + j0 + jj] = acc;
    return;
  }
  const int row = (blockIdx.x - strips) * (kTileThreads / 32) + (t >> 5);
  if (row >= h_count * n) return;
  const float* a = A + (size_t)row * m;
  const float* g = gA + (size_t)row * m;
  float acc = 0.f;
#pragma unroll 4
  for (int j = (t & 31) * 4; j < m; j += 128) {
    float4 av = load4<kVec>(a, j, m);
    float4 gv = load4<kVec>(g, j, m);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = fmaf(at(gv, k), at(av, k), acc);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(kFull, acc, d);
  if ((t & 31) == 0) r[row] = acc;
}

template <bool kVec>
__global__ void __launch_bounds__(kTileThreads)
bwd_write(const float* __restrict__ A, const float* __restrict__ gA,
          const float* __restrict__ C, const float* __restrict__ gCt,
          const unsigned char* __restrict__ mask,
          const unsigned char* __restrict__ cmask, int n, int m, float scale,
          const float* __restrict__ r, const float* __restrict__ c,
          float* __restrict__ out) {
  __shared__ float sG[kTile][kTile + 1];
  const int t = threadIdx.x;
  const int h = blockIdx.z, i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  {
    const int jj = t >> 3, ii = (t & 7) * 4;  // gCt: column jj, rows ii..+3
    float4 gv = j0 + jj < m
                    ? load4<kVec>(gCt + ((size_t)h * m + j0 + jj) * n, i0 + ii, n)
                    : zero;
#pragma unroll
    for (int k = 0; k < 4; ++k) sG[jj][ii + k] = at(gv, k);
  }
  const int li = t >> 3, lj = (t & 7) * 4;  // row li, columns lj..+3
  const int i = i0 + li, j = j0 + lj;
  const size_t off = ((size_t)h * n + min(i, n - 1)) * m;
  float4 a = zero, ga = zero, cc = zero;
  if (i < n) {
    a = load4<kVec>(A + off, j, m);
    ga = load4<kVec>(gA + off, j, m);
    cc = load4<kVec>(C + off, j, m);
  }
  __syncthreads();
  if (i >= n) return;
  const float ri = r[(size_t)h * n + i];
  const bool mi = mask == nullptr || __ldg(mask + i) != 0;
  float4 cj = load4<kVec>(c + (size_t)h * m, j, m);
  bool cm[4];
  flags4(cmask, j, m, cm);
  float4 o;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float g = at(a, k) * (at(ga, k) - ri);
    if (mi) g += at(cc, k) * (sG[lj + k][li] - at(cj, k));
    at(o, k) = cm[k] ? g * scale : 0.f;
  }
  store4<kVec>(out + off, j, m, o);
}

// The forward's row chunks: col_stats takes 512 columns of one head and a
// chunk of rows a CTA, the rows cut so that about kColCtasPerSm CTAs a SM
// fill the card.
struct Plan {
  int rows_per_chunk, chunks;
};

Plan plan(int h, int n, int m, int sms) {
  const int col_blocks = (m + 4 * kColThreads - 1) / (4 * kColThreads);
  const int want = (kColCtasPerSm * sms + h * col_blocks - 1) / (h * col_blocks);
  const int split = want < n ? want : n;
  const int rows = (n + split - 1) / split;
  return {rows, (n + rows - 1) / rows};
}

template <bool kVec>
int forward(const float* raw, const unsigned char* mask,
            const unsigned char* cmask, int h, int n, int m, float scale,
            int sms, float* scratch, float* attn, float* ctx,
            cudaStream_t stream) {
  const Plan p = plan(h, n, m, sms);
  float* pmax = scratch;
  float* psum = pmax + (size_t)h * p.chunks * m;
  float* cmax = psum + (size_t)h * p.chunks * m;
  float* cinv = cmax + (size_t)h * m;
  const dim3 cgrid((m + 4 * kColThreads - 1) / (4 * kColThreads), p.chunks, h);
  col_stats<kVec><<<cgrid, kColThreads, 0, stream>>>(
      raw, mask, cmask, n, m, scale, p.rows_per_chunk, p.chunks, pmax, psum);
  const int hm = h * m;
  col_merge<<<(hm + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
              stream>>>(pmax, psum, h, m, p.chunks, cmax, cinv);
  row_write<kVec><<<h * n, kRowThreads, 0, stream>>>(
      raw, mask, cmask, n, m, scale, cmax, cinv, attn, ctx);
  return (int)cudaGetLastError();
}

template <bool kVec>
int backward(const float* A, const float* C, const float* gA, const float* gCt,
             const unsigned char* mask, const unsigned char* cmask, int h,
             int n, int m, float scale, float* scratch, float* out,
             cudaStream_t stream) {
  float* r = scratch;
  float* c = scratch + (size_t)h * n;
  const int strips = h * ((m + kTile - 1) / kTile);
  const int row_blocks = (h * n + kTileThreads / 32 - 1) / (kTileThreads / 32);
  bwd_stats<kVec><<<strips + row_blocks, kTileThreads, 0, stream>>>(
      A, gA, C, gCt, h, n, m, strips, r, c);
  const dim3 wgrid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, h);
  bwd_write<kVec><<<wgrid, kTileThreads, 0, stream>>>(
      A, gA, C, gCt, mask, cmask, n, m, scale, r, c, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The float32 scratch a launch needs: the forward's chunk statistics and
// column statistics, 2 h (chunks + 1) m floats, or the backward's r and c,
// h (n + m).  sms: the card's multiprocessor count.
extern "C" int gs_dual_softmax_scratch(int backward, int h, int n, int m,
                                       int sms) {
  if (backward) return h * (n + m);
  return 2 * h * (plan(h, n, m, sms).chunks + 1) * m;
}

// raw, attn, ctx: (h, n, m) float32; mask (n,), cmask (m,) bool or null;
// scratch: as gs_dual_softmax_scratch sizes it for the same sms.  vec: n and
// m multiples of 4, every pointer 16-byte aligned.
extern "C" int gs_dual_softmax_fwd(const float* raw, const unsigned char* mask,
                                   const unsigned char* cmask, int h, int n,
                                   int m, float scale, int sms, int vec,
                                   float* scratch, float* attn, float* ctx,
                                   cudaStream_t stream) {
  return vec ? forward<true>(raw, mask, cmask, h, n, m, scale, sms, scratch,
                             attn, ctx, stream)
             : forward<false>(raw, mask, cmask, h, n, m, scale, sms, scratch,
                              attn, ctx, stream);
}

// attn, ctx, g_attn, out: (h, n, m) float32; g_ctx_t: gC's (h, m, n)
// storage; scratch: as gs_dual_softmax_scratch sizes it.
extern "C" int gs_dual_softmax_bwd(const float* attn, const float* ctx,
                                   const float* g_attn, const float* g_ctx_t,
                                   const unsigned char* mask,
                                   const unsigned char* cmask, int h, int n,
                                   int m, float scale, int vec, float* scratch,
                                   float* out, cudaStream_t stream) {
  return vec ? backward<true>(attn, ctx, g_attn, g_ctx_t, mask, cmask, h, n, m,
                              scale, scratch, out, stream)
             : backward<false>(attn, ctx, g_attn, g_ctx_t, mask, cmask, h, n,
                               m, scale, scratch, out, stream);
}
