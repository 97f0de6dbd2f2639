// Vector label burn (GDAL ALL_TOUCHED semantics), written by hand for
// Hopper (sm_90a). Two kernels share one body:
//
// * burn_dense replaces the Pallas kernel of the JAX package
//   ops/rasterize.py:_rasterize_pallas_fn (pallas_call at :342, shared
//   predicate _edge_mask): every canvas block walks all F features in
//   emit order;
// * burn_binned replaces ops/rasterize.py:_rasterize_pallas_binned_fn
//   (pallas_call at :430): each canvas block walks only its own
//   host-built feature list table[block, 0:count[block]], in ascending
//   emit order (ops/rasterize.py:_bin_features, binned with THIS kernel's
//   block shape).
//
// Per pixel and feature: even-odd parity of the crossings of the
// horizontal ray through the pixel centre, OR (with all_touched) "some
// edge touches the closed unit pixel square"; the feature's row window
// [w0, w1) limits the mask; the last feature in emit order whose mask
// holds writes its value. Per (pixel, edge), with (cx, cy) the centre:
//   straddle = (y0 > cy) != (y1 > cy)
//   xint     = fma(q, x1 - x0, x0)        q = (cy - y0) / dy  (IEEE; dy
//                                          0 -> 1)
//   crossing = straddle && cx < xint
//   box      = cx + 0.5 >= min x && cx - 0.5 <= max x       (x half)
//           && cy + 0.5 >= min y && cy - 0.5 <= max y       (y half)
//   touch    = box && |fma(nx, cx - x0, ny * (cy - y0))| <= reach
//              nx = y1 - y0, ny = x0 - x1, reach = (|nx| + |ny|) * 0.5
//
// Numerics reproduce XLA:CPU, which contracts the two fma expressions
// above. They decide pixels on polygon boundaries, so they are written
// with the _rn intrinsics (never contracted), every other operation is
// rounded separately, and the file is compiled with --fmad=false and
// without --use_fast_math. The plain version (ops/rasterize.py) computes
// the same two fused expressions exactly.
//
// Design. One thread per pixel; blocks of bh <= 8 rows x 32 columns, so
// each warp is one row (one cy).
// 1. The block culls its candidate features (all F, or its bin's list)
//    bh x 32 at a time in parallel against its pixel span (bbox dilated
//    0.5 px, row window) and compacts the hits in emit order into shared
//    memory with their edge counts, values and windows.
// 2. Per hit feature, the block stages the real edges in chunks of one
//    edge per thread, keeping (warp ballot + one shared counter) only
//    edges whose y-span dilated by 0.5 px meets the block's rows, with
//    each kept edge's row-independent terms computed once per block.
//    Each thread loads its edge of the next chunk (or of the next
//    feature) before the current chunk is walked, so the load's latency
//    hides behind the walk.
// 3. Each warp whose row lies in the canvas and the window walks the
//    kept edges 32 at a time, lane k on kept edge k: it tests the edge
//    against the row (straddle, or the y half of box) and, only where
//    that holds, does the row's single division (xint) and its row
//    constant ny*(cy-y0). It then writes the edge's effect on the warp's
//    32 pixels as bit masks: crossings are the pixels left of xint, a
//    prefix of ceil(xint - first centre) bits; touches are tested with
//    the per-pixel part of the predicate (x half of box, fused distance)
//    only on the pixels whose x half of box can hold.
// 4. One __reduce_xor_sync and one __reduce_or_sync per 32 edges fold the
//    lanes' masks into the row's parity and touch masks; each pixel reads
//    its bit after the feature's last chunk.
//
// Why the output is bitwise equal to the per-(pixel, edge) predicate:
// every value that decides a pixel is the same float operation on the
// same operands as before; the row-level values depend only on cy and
// the edge, so computing them once per row changes no bit. Pixel centres
// and their +- 0.5 are exact (integers and halves below 2^23, hence the
// canvas limits), so cx < xint holds exactly for the first
// ceil(xint - bx0) pixels: xint - bx0 is exact where it is used (xint in
// (bx0, bx0 + 31], Sterbenz), and the same holds for the x range of the
// touch test, whose pixels are then each tested with the per-pixel
// expressions. An edge is skipped only where it provably gives crossing =
// touch = false: straddle implies the y half of box, and the block's row
// span +- 0.5 and the warp's column span +- 0.5 bound the per-pixel
// tests monotonically. Parity is XOR and touch is OR, so the order in
// which a feature's edges are visited (the compaction reorders them)
// changes nothing; features keep their emit order. Rows outside the
// canvas or the feature's window are masked off before as after.
//
// What bounds it on an H100: the work these inputs need (about 12 fp32
// operations per (row, edge) pair that the y test admits, 14 per (pixel,
// edge) pair whose centre lies in the edge's dilated bbox, one per pixel)
// is well under a microsecond at the path's shapes, and moving the bytes
// (edges in, a float per pixel out) takes a few microseconds at most, so
// the bound is the bytes. What the kernel takes beyond it is latency: a
// block walks its features one after another, each behind two barriers
// and a load of its edges, and the path's grids are about one wave.
//
// Changed from the first port: that kernel culled the features one at a
// time with dependent loads, then evaluated the whole predicate for every
// pixel and every real edge of every feature that passed (one IEEE
// division per pixel-edge pair, 32 identical ones per warp); the wrapper
// also derived bbox and edge counts on the card with a dozen small
// launches. Now the cull is one parallel step, the division is per
// (row, edge) pair that meets the row, edges that miss the row are never
// evaluated, the per-pixel test runs only where the x half of box can
// hold, and bbox and counts come from the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (kernels/__init__.py). Plain C interface, called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRows = 8;                   // rows (warps) of a block
constexpr int kMaxThreads = kWarp * kMaxRows;  // also edges per chunk
constexpr unsigned kFull = 0xffffffffu;

// Per block: the features that survive its cull, in emit order, and the
// row-independent terms of the edges kept for its rows.
struct Shared {
  int feat[kMaxThreads];
  int nedge[kMaxThreads];
  float value[kMaxThreads];
  float2 window[kMaxThreads];
  float4 a[kMaxThreads];  // x0, y0, y1, dy (0 -> 1)
  float4 b[kMaxThreads];  // x1 - x0, ny = x0 - x1, min y, max y
  float4 c[kMaxThreads];  // nx = y1 - y0, reach, min x, max x
  int warp_hits[kMaxRows];
  unsigned n_kept;  // kept edges so far, over all chunks
};

// kBinned: candidates are table[block, 0:count[block]]; else 0..F-1.
template <bool kBinned, bool kTouched>
__global__ void __launch_bounds__(kMaxThreads)
    burn_kernel(const float4* __restrict__ edges,
                const int* __restrict__ nedges,
                const float* __restrict__ values,
                const float2* __restrict__ windows,
                const float4* __restrict__ bbox, int E, int n_features,
                const int* __restrict__ count,
                const int* __restrict__ table, int S, int H, int W,
                float background, float* __restrict__ out) {
  __shared__ Shared sh;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int col0 = blockIdx.x * kWarp;  // first column of the block
  const int col = col0 + lane;
  const int row = blockIdx.y * blockDim.y + warp;
  const int tid = warp * kWarp + lane;
  const int nthreads = kWarp * blockDim.y;  // edges staged per chunk
  const float cy = __fadd_rn((float)row, 0.5f);
  const float cy_lo = __fsub_rn(cy, 0.5f), cy_hi = __fadd_rn(cy, 0.5f);
  // pixel-centre span of this block (its columns are each warp's)
  const float bx0 = __fadd_rn((float)col0, 0.5f);
  const float by0 = __fadd_rn((float)(blockIdx.y * blockDim.y), 0.5f);
  const float bx1 = __fadd_rn(bx0, (float)(kWarp - 1));
  const float by1 = __fadd_rn(by0, (float)(blockDim.y - 1));
  const float bx_lo = __fsub_rn(bx0, 0.5f), bx_hi = __fadd_rn(bx1, 0.5f);
  const float by_lo = __fsub_rn(by0, 0.5f), by_hi = __fadd_rn(by1, 0.5f);
  const unsigned below = (1u << lane) - 1u;

  int n_cand = n_features;
  const int* cand = nullptr;
  if (kBinned) {
    const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    n_cand = count[b];
    cand = table + b * S;
  }
  if (tid == 0) sh.n_kept = 0u;
  unsigned kept_before = 0u;

  float val = background;
  for (int base = 0; base < n_cand; base += nthreads) {
    // 1. cull nthreads candidates at once; keep the hits in emit order.
    // Sound: the touch test reaches 0.5 px beyond the edge bbox, the
    // interior lies inside it, and the row window bounds the burn.
    const int i = base + tid;
    int f = 0, ne = 0;
    float2 w = make_float2(0.f, 0.f);
    bool hit = false;
    if (i < n_cand) {
      f = kBinned ? cand[i] : i;
      const float4 bb = bbox[f];
      w = windows[f];
      ne = min(nedges[f], E);  // never past the feature's E edges
      hit = ne > 0 && __fsub_rn(bb.x, 0.5f) <= bx1 &&
            __fadd_rn(bb.z, 0.5f) >= bx0 && __fsub_rn(bb.y, 0.5f) <= by1 &&
            __fadd_rn(bb.w, 0.5f) >= by0 && w.x <= by1 && w.y > by0;
    }
    const unsigned vote = __ballot_sync(kFull, hit);
    __syncthreads();  // the previous batch is done with sh
    if (lane == 0) sh.warp_hits[warp] = __popc(vote);
    __syncthreads();
    int slot = __popc(vote & below), n_hit = 0;
    for (int v = 0; v < (int)blockDim.y; ++v) {
      slot += v < warp ? sh.warp_hits[v] : 0;
      n_hit += sh.warp_hits[v];
    }
    if (hit) {
      sh.feat[slot] = f;
      sh.nedge[slot] = ne;
      sh.value[slot] = values[f];
      sh.window[slot] = w;
    }
    __syncthreads();
    if (n_hit == 0) continue;  // uniform across the block

    // 2. per hit feature and chunk of its edges: stage the edges that
    // meet the block's rows, then walk them per warp. Each thread loads
    // its edge of the next chunk before the current one is walked.
    auto load = [&](int h, int c0) {
      const int k = c0 + tid;
      return h < n_hit && k < sh.nedge[h]
                 ? edges[(long long)sh.feat[h] * E + k]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    float4 next = load(0, 0);
    for (int h = 0; h < n_hit; ++h) {
      const float2 wh = sh.window[h];
      const int ne_h = sh.nedge[h];
      // uniform across the warp: its row is in the canvas and the window
      const bool live = row < H && cy >= wh.x && cy < wh.y;
      unsigned parity = 0u, touch = 0u;  // bit j: pixel col0 + j of the row
      for (int c0 = 0; c0 < ne_h; c0 += nthreads) {
        const float4 e = next;
        const bool have = c0 + tid < ne_h;
        next = c0 + nthreads < ne_h ? load(h, c0 + nthreads) : load(h + 1, 0);
        const float ylo = fminf(e.y, e.w), yhi = fmaxf(e.y, e.w);
        const bool keep = have && by_hi >= ylo && by_lo <= yhi;
        const unsigned kvote = __ballot_sync(kFull, keep);
        __syncthreads();  // the previous chunk's records are read
        unsigned at = 0u;
        if (lane == 0 && kvote != 0u)
          at = atomicAdd(&sh.n_kept, __popc(kvote));
        at = __shfl_sync(kFull, at, 0);
        if (keep) {
          const int k = (int)(at - kept_before) + __popc(kvote & below);
          const float dy = __fsub_rn(e.w, e.y);
          const float ny = __fsub_rn(e.x, e.z);
          sh.a[k] = make_float4(e.x, e.y, e.w, dy == 0.f ? 1.f : dy);
          sh.b[k] = make_float4(__fsub_rn(e.z, e.x), ny, ylo, yhi);
          sh.c[k] = make_float4(
              dy, __fmul_rn(__fadd_rn(fabsf(dy), fabsf(ny)), 0.5f),
              fminf(e.x, e.z), fmaxf(e.x, e.z));
        }
        __syncthreads();
        const unsigned total = sh.n_kept;
        const int nk = (int)(total - kept_before);
        kept_before = total;
        if (!live) continue;
        for (int g = 0; g < nk; g += kWarp) {
          // lane k: kept edge g + k against this warp's row, as bit masks
          // over the warp's 32 pixels (bit j: pixel column col0 + j)
          const int k = g + lane;
          unsigned cross = 0u, touched = 0u;
          if (k < nk) {
            const float4 a = sh.a[k];
            const float4 b = sh.b[k];
            const bool strad = (a.y > cy) != (a.z > cy);
            const bool ybox = kTouched && cy_hi >= b.z && cy_lo <= b.w;
            if (strad || ybox) {
              const float t = __fsub_rn(cy, a.y);
              const float xint = __fmaf_rn(__fdiv_rn(t, a.w), b.x, a.x);
              // crossed by the pixels with bx0 + j < xint: the first
              // ceil(xint - bx0) of them (the difference is exact)
              if (strad && xint > bx1) {
                cross = kFull;
              } else if (strad && xint > bx0) {
                cross = (1u << (int)ceilf(__fsub_rn(xint, bx0))) - 1u;
              }
              const float4 c = sh.c[k];
              if (ybox && bx_hi >= c.z && bx_lo <= c.w) {
                // the pixels whose x half of box can hold, col0 + j + 1 >=
                // min x and col0 + j <= max x, each tested exactly
                const float tail = __fmul_rn(b.y, t);
                const int j0 = (int)ceilf(fminf(fmaxf(__fsub_rn(c.z, bx_lo),
                                                      0.f), 32.f)) - 1;
                const int j1 = (int)floorf(fminf(fmaxf(__fsub_rn(c.w, bx_lo),
                                                       -1.f), 31.f));
                for (int j = max(j0, 0); j <= j1; ++j) {
                  const float px = __fadd_rn((float)(col0 + j), 0.5f);
                  const bool xbox = __fadd_rn(px, 0.5f) >= c.z &&
                                    __fsub_rn(px, 0.5f) <= c.w;
                  const float dist =
                      fabsf(__fmaf_rn(c.x, __fsub_rn(px, a.x), tail));
                  if (xbox && dist <= c.y) touched |= 1u << j;
                }
              }
            }
          }
          parity ^= __reduce_xor_sync(kFull, cross);
          if (kTouched) touch |= __reduce_or_sync(kFull, touched);
        }
      }
      if (live && ((parity | touch) >> lane & 1u) != 0u) val = sh.value[h];
    }
  }
  if (row < H && col < W) out[(long long)row * W + col] = val;
}

template <bool kBinned>
void launch(bool all_touched, dim3 grid, dim3 block, cudaStream_t stream,
            const float4* edges, const int* nedges, const float* values,
            const float2* windows, const float4* bbox, int E, int F,
            const int* count, const int* table, int S, int H, int W,
            float background, float* out) {
  if (all_touched)
    burn_kernel<kBinned, true><<<grid, block, 0, stream>>>(
        edges, nedges, values, windows, bbox, E, F, count, table, S, H, W,
        background, out);
  else
    burn_kernel<kBinned, false><<<grid, block, 0, stream>>>(
        edges, nedges, values, windows, bbox, E, F, count, table, S, H, W,
        background, out);
}

dim3 grid_for(int H, int W, int bh) {
  return dim3((unsigned)((W + kWarp - 1) / kWarp),
              (unsigned)((H + bh - 1) / bh));
}

// blocks are bh <= kMaxRows rows of one warp each (bw must be 32); pixel
// centres and their +- 0.5 stay exact integers and halves in float32
bool bad_shape(int F, int E, int H, int W, int bh, int bw) {
  return F < 1 || E < 1 || H < 1 || W < 1 || bh < 1 || bh > kMaxRows ||
         bw != kWarp || (H + bh - 1) / bh > 65535 || W > (1 << 22);
}

}  // namespace

// edges (F, E, 4) float32, 16-byte aligned; nedges (F) int32 real edges
// per feature (real edges come first; read as at most E); values (F);
// windows (F, 2), 8-byte aligned; bbox (F, 4) [minx, miny, maxx, maxy]
// over real edges, 16-byte aligned; out (H, W) float32. A bbox smaller
// than the real edges' culls pixels that the feature covers.
// Blocks of bh x bw threads, bh <= 8, bw = 32. Returns a cudaError_t (0 =
// launched).
extern "C" int burn_dense_launch(const void* edges, const void* nedges,
                                 const void* values, const void* windows,
                                 const void* bbox, int F, int E, int H, int W,
                                 float background, int all_touched, int bh,
                                 int bw, void* out, void* stream) {
  if (bad_shape(F, E, H, W, bh, bw)) return (int)cudaErrorInvalidValue;
  launch<false>(all_touched != 0, grid_for(H, W, bh), dim3(bw, bh),
                static_cast<cudaStream_t>(stream),
                static_cast<const float4*>(edges),
                static_cast<const int*>(nedges),
                static_cast<const float*>(values),
                static_cast<const float2*>(windows),
                static_cast<const float4*>(bbox), E, F, nullptr, nullptr, 0,
                H, W, background, static_cast<float*>(out));
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
  launch<true>(all_touched != 0, grid_for(H, W, bh), dim3(bw, bh),
               static_cast<cudaStream_t>(stream),
               static_cast<const float4*>(edges),
               static_cast<const int*>(nedges),
               static_cast<const float*>(values),
               static_cast<const float2*>(windows),
               static_cast<const float4*>(bbox), E, F,
               static_cast<const int*>(count),
               static_cast<const int*>(table), S, H, W, background,
               static_cast<float*>(out));
  return (int)cudaGetLastError();
}
