// Vector label burn (GDAL ALL_TOUCHED semantics), written by hand for
// Hopper (sm_90a). Two kernels share one per-edge predicate:
//
// * burn_dense replaces the Pallas kernel of the JAX package
//   ops/rasterize.py:_rasterize_pallas_fn (shared predicate _edge_mask):
//   every canvas block walks all F features in emit order;
// * burn_binned replaces ops/rasterize.py:_rasterize_pallas_binned_fn:
//   each canvas block walks only its own host-built feature list
//   table[block, 0:count[block]], in ascending emit order
//   (ops/rasterize.py:_bin_features, binned with THIS kernel's block shape).
//
// Per pixel and feature: even-odd parity of the crossings of the
// horizontal ray through the pixel centre, OR (with all_touched) "some
// edge touches the closed unit pixel square"; the feature's row window
// [w0, w1) limits the mask; the last feature in emit order whose mask
// holds writes its value.
//
// Numerics reproduce XLA:CPU, which contracts two of the predicate's
// expressions into fused multiply-adds:
//   xint = fma(q, x1 - x0, x0)           with q = (cy - y0) / dy  (IEEE)
//   dist = |fma(nx, cx - x0, ny * (cy - y0))|
// These values decide pixels on polygon boundaries, so they are written
// with the _rn intrinsics (never contracted), every other operation is
// rounded separately, and the file is compiled with --fmad=false and
// without --use_fast_math. The plain version (ops/rasterize.py) computes
// the same two fused expressions exactly.
//
// What bounds it on an H100: the work is F_hit x E x pixels predicate
// evaluations (~20 fp32 operations each) against a few bytes per pixel of
// output, so the fp32 ALU rate is the bound, not memory.
//
// What the design does about it:
// * one thread per pixel; the canvas value stays in a register across the
//   whole feature loop and is written once;
// * each feature is culled per block by its bbox dilated 0.5 px and its
//   row window, a uniform branch, so culled features cost a few loads;
// * the binned kernel skips culled features entirely through its list;
// * each feature's edges are staged in shared memory in chunks, once per
//   block, and read as broadcasts by every thread;
// * only a feature's real edges are read (padding edges never burn).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (kernels/__init__.py). Plain C interface, called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEdgeChunk = 256;

__device__ __forceinline__ void edge_predicate(const float4 e, const float cx,
                                               const float cy,
                                               const bool all_touched,
                                               unsigned& parity,
                                               unsigned& touch) {
  const float x0 = e.x, y0 = e.y, x1 = e.z, y1 = e.w;
  const bool straddle = (y0 > cy) != (y1 > cy);
  const float dy = __fsub_rn(y1, y0);
  const float safe_dy = dy == 0.f ? 1.f : dy;
  const float q = __fdiv_rn(__fsub_rn(cy, y0), safe_dy);
  const float xint = __fmaf_rn(q, __fsub_rn(x1, x0), x0);
  parity ^= (straddle && cx < xint) ? 1u : 0u;
  if (all_touched) {
    const bool box = __fadd_rn(cx, 0.5f) >= fminf(x0, x1) &&
                     __fsub_rn(cx, 0.5f) <= fmaxf(x0, x1) &&
                     __fadd_rn(cy, 0.5f) >= fminf(y0, y1) &&
                     __fsub_rn(cy, 0.5f) <= fmaxf(y0, y1);
    const float nx = dy;
    const float ny = __fsub_rn(x0, x1);
    const float dist = fabsf(__fmaf_rn(nx, __fsub_rn(cx, x0),
                                       __fmul_rn(ny, __fsub_rn(cy, y0))));
    const float reach = __fmul_rn(__fadd_rn(fabsf(nx), fabsf(ny)), 0.5f);
    touch |= (box && dist <= reach) ? 1u : 0u;
  }
}

// kBinned: features come from table[block, 0:count[block]]; else 0..F-1.
template <bool kBinned>
__global__ void burn_kernel(const float4* __restrict__ edges,
                            const int* __restrict__ nedges,
                            const float* __restrict__ values,
                            const float* __restrict__ windows,
                            const float* __restrict__ bbox, int F, int E,
                            const int* __restrict__ count,
                            const int* __restrict__ table, int S, int H,
                            int W, float background, int all_touched,
                            float* __restrict__ out) {
  __shared__ float4 sedge[kEdgeChunk];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const float cx = __fadd_rn((float)col, 0.5f);
  const float cy = __fadd_rn((float)row, 0.5f);
  // pixel-centre span of this block, for the per-feature cull
  const float bx0 = __fadd_rn((float)(blockIdx.x * blockDim.x), 0.5f);
  const float by0 = __fadd_rn((float)(blockIdx.y * blockDim.y), 0.5f);
  const float bx1 = __fadd_rn(bx0, (float)(blockDim.x - 1));
  const float by1 = __fadd_rn(by0, (float)(blockDim.y - 1));
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const bool at = all_touched != 0;

  int n_list = F;
  const int* list = nullptr;
  if (kBinned) {
    const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    n_list = count[b];
    list = table + b * S;
  }

  float val = background;
  for (int s = 0; s < n_list; ++s) {
    const int f = kBinned ? list[s] : s;
    const float w0 = windows[2 * f];
    const float w1 = windows[2 * f + 1];
    const float* bb = bbox + 4 * f;
    // sound cull: the touch test reaches 0.5 px beyond the edge bbox and
    // the interior lies inside it; the row window bounds it too
    const bool hit = __fsub_rn(bb[0], 0.5f) <= bx1 &&
                     __fadd_rn(bb[2], 0.5f) >= bx0 &&
                     __fsub_rn(bb[1], 0.5f) <= by1 &&
                     __fadd_rn(bb[3], 0.5f) >= by0 && w0 <= by1 && w1 > by0;
    if (!hit) continue;  // uniform across the block
    unsigned parity = 0u, touch = 0u;
    const int ne = nedges[f];
    const float4* fe = edges + (long long)f * E;
    for (int c0 = 0; c0 < ne; c0 += kEdgeChunk) {
      const int nc = min(kEdgeChunk, ne - c0);
      __syncthreads();
      for (int k = tid; k < nc; k += nthreads) sedge[k] = fe[c0 + k];
      __syncthreads();
      for (int k = 0; k < nc; ++k)
        edge_predicate(sedge[k], cx, cy, at, parity, touch);
    }
    const bool mask = ((at ? (parity | touch) : parity) != 0u) && cy >= w0 &&
                      cy < w1;
    if (mask) val = values[f];
  }
  if (row < H && col < W) out[(long long)row * W + col] = val;
}

dim3 grid_for(int H, int W, int bh, int bw) {
  return dim3((unsigned)((W + bw - 1) / bw), (unsigned)((H + bh - 1) / bh));
}

bool bad_shape(int F, int E, int H, int W, int bh, int bw) {
  return F < 1 || E < 1 || H < 1 || W < 1 || bh < 1 || bw < 1 ||
         bh * bw > 1024 || (H + bh - 1) / bh > 65535;
}

}  // namespace

// edges (F, E, 4) float32, 16-byte aligned; nedges (F) int32 real edges
// per feature; values (F); windows (F, 2); bbox (F, 4) [minx, miny, maxx,
// maxy]; out (H, W) float32. Returns a cudaError_t (0 = launched).
extern "C" int burn_dense_launch(const void* edges, const void* nedges,
                                 const void* values, const void* windows,
                                 const void* bbox, int F, int E, int H, int W,
                                 float background, int all_touched, int bh,
                                 int bw, void* out, void* stream) {
  if (bad_shape(F, E, H, W, bh, bw)) return (int)cudaErrorInvalidValue;
  burn_kernel<false><<<grid_for(H, W, bh, bw), dim3(bw, bh), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(edges), static_cast<const int*>(nedges),
      static_cast<const float*>(values), static_cast<const float*>(windows),
      static_cast<const float*>(bbox), F, E, nullptr, nullptr, 0, H, W,
      background, all_touched, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// As burn_dense_launch, plus count (Gi, Gj) int32 and table (Gi, Gj, S)
// int32 with Gi = ceil(H / bh), Gj = ceil(W / bw).
extern "C" int burn_binned_launch(const void* edges, const void* nedges,
                                  const void* values, const void* windows,
                                  const void* bbox, int F, int E,
                                  const void* count, const void* table, int S,
                                  int H, int W, float background,
                                  int all_touched, int bh, int bw, void* out,
                                  void* stream) {
  if (bad_shape(F, E, H, W, bh, bw) || S < 1)
    return (int)cudaErrorInvalidValue;
  burn_kernel<true><<<grid_for(H, W, bh, bw), dim3(bw, bh), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(edges), static_cast<const int*>(nedges),
      static_cast<const float*>(values), static_cast<const float*>(windows),
      static_cast<const float*>(bbox), F, E,
      static_cast<const int*>(count), static_cast<const int*>(table), S, H,
      W, background, all_touched, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
