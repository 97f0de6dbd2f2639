// Masked temporal median over the scene axis, written by hand for Hopper
// (sm_90a). Replaces the Pallas kernel of the JAX package,
// ops/compositing.py:_median_pallas_fn (entry masked_median_pallas).
//
// What it computes, per output element (pixel, band): the n samples whose
// scene is valid at that pixel are ranked; the result is the mean of ranks
// (n-1)/2 and n/2, i.e. (lo + hi) * 0.5f in float32, and 0 where n == 0.
// The output is bit-identical to the plain version
// (ops/compositing.py:masked_median), which ranks invalid samples last by
// giving them the value 3.0e38f and sorts NaN above everything.
//
// Exactness of the sentinels. Only ranks below n are read, and an invalid
// sample is at least as large as every valid one, so the r-th smallest
// value for r < n is the same whatever the invalid samples hold, as long
// as they rank at or above every valid sample:
// * uint16 stacks: invalid samples hold 0xFFFF, even where a valid sample
//   is 65535 itself; values are compared as unsigned 16-bit integers;
// * float32 stacks: values are compared as 32-bit integer keys of the same
//   total order as the plain version's sort (negative floats have their
//   low 31 bits flipped, every NaN becomes the largest key), and invalid
//   samples hold the key of 3.0e38f, exactly as the plain version does.
//   Keys order -0.0 below +0.0, which the plain sort keeps in input order:
//   a median rank that holds zeros of both signs may differ in the sign of
//   a zero result.
//
// What bounds it on an H100: at the chip path's S = 10 scenes, each output
// element reads 10 uint16 samples and 10/B validity bytes and writes 5
// bytes (~26 bytes) for 32 compare-exchanges: device-memory bandwidth
// (3.35 TB/s) is the bound, and the kernel's task is to keep enough bytes
// in flight. At S = 73 (a year of Sentinel-2 at a 5-day cadence) the
// network holds 849 compare-exchanges an element: instructions, not
// bytes, hold the kernel there.
//
// What the design does about it:
// * staged kernel, for aligned stacks whose pixel rows are a multiple of
//   16 bytes (the catalog's tiles): persistent blocks walk tiles of
//   128 * V elements; warp 0 copies the next tiles' scene rows and
//   validity rows into a ring of two or three shared-memory stages with
//   bulk copies (TMA) completing on mbarriers, while the block sorts the
//   current tile from shared memory. So the copies in flight do not
//   depend on the registers the sort holds;
// * direct kernel, for any other stack: one vector of V elements a thread
//   read from device memory, every scene's load issued before the first
//   is used (no branch between them);
// * each thread takes V consecutive elements, so each scene is one 4-, 8-
//   or 16-byte load a thread; offsets are 32-bit (the entry point refuses
//   stacks of 2^31 elements or more);
// * validity is per pixel: where B >= V a thread's elements lie in at most
//   two pixels, so it reads two validity bytes a scene and keeps two valid
//   counts (other threads, and the ragged or unaligned ones, go element by
//   element); the ranks are picked by a tree of selects on their bits;
// * uint16 samples stay 16-bit: two elements share one 32-bit register and
//   a compare-exchange is one min.u16x2 and one max.u16x2 for both; float32
//   keys take one min.s32 and one max.s32; no NaN-aware float compares;
// * Batcher's odd-even merge sort sized to S: the network of the next power
//   of two keeps only the comparators whose upper index is below the
//   width, which padded scenes would never change (they hold the largest
//   value). Exact widths 1..16 are compiled for uint16, the scene counts
//   catalogs deliver; above that a few widths up to 128, padded with
//   scenes that rank above every sample. 32 compare-exchanges at S = 10
//   (a bitonic network padded to 16 runs 80), 849 at S = 73 (1,792 at 128);
// * the samples live in registers: the comparator table is computed at
//   compile time and every register index is a template argument, and
//   only ranks up to width / 2 are selected, so nothing is indexed at run
//   time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (kernels/__init__.py). Plain C interface, called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// uint16 samples, two to a 32-bit word (element 2j in the low half).
struct U16 {
  using T = uint16_t;
  static constexpr int kPer = 2;
  static constexpr uint32_t kInvalid = 0xFFFFFFFFu;
  static constexpr uint32_t kPad = kInvalid;
  __device__ __forceinline__ static uint32_t lo(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ static uint32_t hi(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ static uint32_t key(uint32_t raw) { return raw; }
  // invalid halves (bit h of ok clear) take 0xFFFF
  __device__ __forceinline__ static uint32_t mask(uint32_t w, unsigned ok) {
    return w | ((ok & 1u) ? 0u : 0xFFFFu) | ((ok & 2u) ? 0u : 0xFFFF0000u);
  }
  // w with the elements of pixel a (bits in_a) and pixel b made invalid
  // where that pixel's scene is invalid
  __device__ __forceinline__ static uint32_t mask_ab(uint32_t w, uint32_t in_a,
                                                     uint32_t in_b, bool a,
                                                     bool b) {
    return w | (a ? 0u : in_a) | (b ? 0u : in_b);
  }
  __device__ __forceinline__ static uint32_t lane_bits(int h) {
    return 0xFFFFu << (16 * h);
  }
  __device__ __forceinline__ static float value(uint32_t w, int h) {
    return static_cast<float>((w >> (16 * h)) & 0xFFFFu);
  }
};

// float32 samples as signed 32-bit keys, one to a word.
struct F32 {
  using T = float;
  static constexpr int kPer = 1;
  // key of 3.0e38f (0x7F61B1E6): positive, so the key is its bits
  static constexpr uint32_t kInvalid = 0x7F61B1E6u;
  // padded scenes rank above every sample, NaN included (the key of NaN)
  static constexpr uint32_t kPad = 0x7FFFFFFFu;
  __device__ __forceinline__ static uint32_t lo(uint32_t a, uint32_t b) {
    return static_cast<uint32_t>(min(static_cast<int>(a), static_cast<int>(b)));
  }
  __device__ __forceinline__ static uint32_t hi(uint32_t a, uint32_t b) {
    return static_cast<uint32_t>(max(static_cast<int>(a), static_cast<int>(b)));
  }
  // an involution on non-NaN bits: negative floats flip their low 31 bits
  __device__ __forceinline__ static uint32_t flip(uint32_t u) {
    return u ^ (static_cast<uint32_t>(static_cast<int>(u) >> 31) >> 1);
  }
  __device__ __forceinline__ static uint32_t key(uint32_t raw) {
    const bool nan = (raw & 0x7FFFFFFFu) > 0x7F800000u;
    return nan ? 0x7FFFFFFFu : flip(raw);
  }
  __device__ __forceinline__ static uint32_t mask(uint32_t w, unsigned ok) {
    return (ok & 1u) ? w : uint32_t{kInvalid};
  }
  __device__ __forceinline__ static uint32_t mask_ab(uint32_t w, uint32_t in_a,
                                                     uint32_t, bool a, bool b) {
    return (in_a ? a : b) ? w : uint32_t{kInvalid};
  }
  __device__ __forceinline__ static uint32_t lane_bits(int) { return ~0u; }
  __device__ __forceinline__ static float value(uint32_t w, int) {
    return __uint_as_float(flip(w));
  }
};

// Batcher's odd-even merge sort of N values (N need not be a power of
// two): the comparators of the next power of two whose upper index is
// below N, in order. The same generator as the JAX package's
// ops/compositing.py:_batcher_pairs. With out == nullptr it only counts.
constexpr int batcher_pairs(int n, int* out_a, int* out_b) {
  int count = 0;
  for (int p = 1; p < n; p <<= 1)
    for (int k = p; k >= 1; k >>= 1)
      for (int j = k % p; j < n - k; j += 2 * k)
        for (int i = 0; i < k && i < n - j - k; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            if (out_a != nullptr) {
              out_a[count] = i + j;
              out_b[count] = i + j + k;
            }
            ++count;
          }
  return count;
}

template <int C>
struct PairTable {
  int a[C > 0 ? C : 1];
  int b[C > 0 ? C : 1];
};

template <int N>
constexpr int kPairCount = batcher_pairs(N, nullptr, nullptr);

template <int N>
constexpr PairTable<kPairCount<N>> make_pairs() {
  PairTable<kPairCount<N>> t{};
  batcher_pairs(N, t.a, t.b);
  return t;
}

template <int N>
constexpr PairTable<kPairCount<N>> kPairs = make_pairs<N>();

// Comparators [LO, HI) of the width-N network on v, split in halves so
// that every register index is a template argument: nothing is indexed
// at run time, whatever the unroller does.
template <class L, int N, int NW, int LO, int HI>
__device__ __forceinline__ void sort_range(uint32_t (&v)[N][NW]) {
  if constexpr (HI - LO == 1) {
    constexpr int a = kPairs<N>.a[LO];
    constexpr int b = kPairs<N>.b[LO];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t x = v[a][w];
      const uint32_t y = v[b][w];
      v[a][w] = L::lo(x, y);
      v[b][w] = L::hi(x, y);
    }
  } else if constexpr (HI - LO > 1) {
    sort_range<L, N, NW, LO, (LO + HI) / 2>(v);
    sort_range<L, N, NW, (LO + HI) / 2, HI>(v);
  }
}

template <class L, int N, int NW>
__device__ __forceinline__ void batcher_sort(uint32_t (&v)[N][NW]) {
  sort_range<L, N, NW, 0, kPairCount<N>>(v);
}

// NW words of one scene's V elements from p (aligned to their size).
template <int NW>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[NW]) {
  if constexpr (NW == 4) {
    const uint4 r = *static_cast<const uint4*>(p);
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  } else if constexpr (NW == 2) {
    const uint2 r = *static_cast<const uint2*>(p);
    w[0] = r.x; w[1] = r.y;
  } else {
    static_assert(NW == 1, "1, 2 or 4 words");
    w[0] = *static_cast<const uint32_t*>(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* med, uint8_t* any,
                                          const float (&m)[V],
                                          const bool (&a)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(med + k) =
          make_float4(m[k], m[k + 1], m[k + 2], m[k + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(med) = make_float2(m[0], m[1]);
  } else {
    med[0] = m[0];
  }
  uint64_t bytes = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) bytes |= static_cast<uint64_t>(a[k]) << (8 * k);
  if constexpr (V == 8) *reinterpret_cast<uint2*>(any) =
      make_uint2(static_cast<uint32_t>(bytes), static_cast<uint32_t>(bytes >> 32));
  else if constexpr (V == 4) *reinterpret_cast<uint32_t*>(any) =
      static_cast<uint32_t>(bytes);
  else if constexpr (V == 2) *reinterpret_cast<uint16_t*>(any) =
      static_cast<uint16_t>(bytes);
  else any[0] = static_cast<uint8_t>(bytes);
}

// Word j of the sorted scenes at rank idx, for idx in [LO, LO + SIZE)
// (SIZE a power of two, LO a multiple of it): a tree of selects on the
// bits of idx, each bit tested once. The median's ranks are at most N / 2,
// so the tree has no leaf above.
template <int N, int NW, int LO, int SIZE>
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[N][NW], int j,
                                         int idx) {
  if constexpr (SIZE == 1 || LO + SIZE / 2 > N / 2) {
    if constexpr (SIZE == 1) return v[LO][j];
    else return pick<N, NW, LO, SIZE / 2>(v, j, idx);
  } else {
    return (idx & (SIZE / 2)) ? pick<N, NW, LO + SIZE / 2, SIZE / 2>(v, j, idx)
                              : pick<N, NW, LO, SIZE / 2>(v, j, idx);
  }
}

// the least power of two >= n
template <int N>
constexpr int kPow2Above = N <= 1 ? 1 : 2 * kPow2Above<(N + 1) / 2>;

// Scenes [0, S) of one thread's V elements, which lie in pixel a and,
// from element `split` on, in pixel b (the next one; split >= V: none):
// the scene s row of the elements at rows + s * row_stride, of pixel a's
// validity at vrows + s * vrow_stride (pixel b's next to it). Two validity
// bytes a scene, two valid counts, and each pixel's invalid masks built
// once. No branch between the scenes' loads, so that they are all in
// flight at once: padded scenes re-read scene S - 1 and are replaced.
template <class L, int N, int V>
__device__ __forceinline__ void load_pixels(
    const typename L::T* rows, int row_stride, const uint8_t* vrows,
    int vrow_stride, int S, int split, uint32_t (&v)[N][V / L::kPer],
    int (&cnt)[V]) {
  constexpr int NW = V / L::kPer;
  const int two = split < V ? 1 : 0;
  uint32_t in_a[NW], in_b[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) in_a[j] = in_b[j] = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const uint32_t bits = L::lane_bits(k % L::kPer);
    if (k < split) in_a[k / L::kPer] |= bits;
    else in_b[k / L::kPer] |= bits;
  }
  int na = 0, nb = 0;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const bool real = s < S;
    const int sc = real ? s : S - 1;
    uint32_t w[NW];
    load_words<NW>(rows + sc * row_stride, w);
    const uint8_t* vrow = vrows + sc * vrow_stride;
    const bool a = real & (vrow[0] != 0);
    const bool b = real & (two != 0) & (vrow[two] != 0);
    na += a;
    nb += b;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      v[s][j] = real ? L::mask_ab(L::key(w[j]), in_a[j], in_b[j], a, b)
                     : L::kPad;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) cnt[k] = k < split ? na : nb;
}

// Scenes [0, S) of elements [e0, e0 + V) for any thread: element by
// element, each with its own pixel; elements past the end re-read the
// last element and count as invalid.
template <class L, int N, int V>
__device__ __forceinline__ void load_elements(
    const typename L::T* __restrict__ stack, const uint8_t* __restrict__ valid,
    int S, int n_elem, int n_pix, int B, int e0,
    uint32_t (&v)[N][V / L::kPer], int (&cnt)[V]) {
  constexpr int NW = V / L::kPer;
  int elem[V], pix[V];
  bool inside[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    inside[k] = e0 + k < n_elem;
    elem[k] = inside[k] ? e0 + k : n_elem - 1;
    pix[k] = elem[k] / B;
    cnt[k] = 0;
  }
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const bool real = s < S;
    const int sc = real ? s : S - 1;
    const typename L::T* row = stack + sc * n_elem;
    const uint8_t* vrow = valid + sc * n_pix;
    uint32_t w[NW];
    unsigned ok[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = ok[j] = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      uint32_t raw;
      if constexpr (L::kPer == 2) raw = row[elem[k]];
      else raw = __float_as_uint(row[elem[k]]);
      w[k / L::kPer] |= raw << (32 / L::kPer * (k % L::kPer));
      const bool o = real & inside[k] & (vrow[pix[k]] != 0);
      cnt[k] += o;
      ok[k / L::kPer] |= static_cast<unsigned>(o) << (k % L::kPer);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
      v[s][j] = real ? L::mask(L::key(w[j]), ok[j]) : L::kPad;
  }
}

// Sort, pick ranks (n-1)/2 and n/2 of each element, and write elements
// [e0, e0 + V) (vector stores where `vec`, else those below n_elem).
template <class L, int N, int V>
__device__ __forceinline__ void finish(uint32_t (&v)[N][V / L::kPer],
                                       const int (&cnt)[V], float* med,
                                       uint8_t* any_valid, int e0,
                                       int n_elem, bool vec) {
  constexpr int NW = V / L::kPer;
  batcher_sort<L, N, NW>(v);
  constexpr int kRanks = kPow2Above<N / 2 + 1>;
  float m[V];
  bool a[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int n = cnt[k];
    const int nz = n > 1 ? n : 1;
    const int j = k / L::kPer;
    const int h = k % L::kPer;
    const uint32_t lo = pick<N, NW, 0, kRanks>(v, j, (nz - 1) >> 1);
    const uint32_t hi = pick<N, NW, 0, kRanks>(v, j, nz >> 1);
    m[k] = n > 0 ? __fmul_rn(__fadd_rn(L::value(lo, h), L::value(hi, h)), 0.5f)
                 : 0.f;
    a[k] = n > 0;
  }
  if (vec) {
    store_vec<V>(med + e0, any_valid + e0, m, a);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (e0 + k < n_elem) {
        med[e0 + k] = m[k];
        any_valid[e0 + k] = a[k];
      }
    }
  }
}

// One thread: elements [e0, e0 + V) of every scene, read from device
// memory. For stacks the staged kernel does not take (unaligned, B < V,
// pixel rows not a multiple of 16 bytes).
template <class L, int N, int V>
__global__ void __launch_bounds__(kThreads)
masked_median_direct(const typename L::T* __restrict__ stack,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ med, uint8_t* __restrict__ any_valid,
                     int S, int n_elem, int n_pix, int B, bool vec_ok) {
  constexpr int NW = V / L::kPer;
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (e0 >= n_elem) return;
  // the last thread may hold fewer than V elements: element loads there
  const bool vec = vec_ok && e0 + V <= n_elem;
  uint32_t v[N][NW];
  int cnt[V];
  if (vec && B >= V) {
    const int p0 = e0 / B;
    load_pixels<L, N, V>(stack + e0, n_elem, valid + p0, n_pix, S,
                         B - (e0 - p0 * B), v, cnt);
  } else {
    load_elements<L, N, V>(stack, valid, S, n_elem, n_pix, B, e0, v, cnt);
  }
  finish<L, N, V>(v, cnt, med, any_valid, e0, n_elem, vec);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the mbarrier's phase of this parity to complete. A copy that
// never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
#pragma unroll 1
  for (int tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == 1 << 24) __trap();
  }
}

// Warp 0 of a block: bulk copies (TMA) of the tile of E elements from e0
// into a stage of shared memory (S rows of E samples, then S rows of vb
// validity bytes from the 16-byte-aligned pixel vb0 at or below the
// tile's first), completion counted in bytes on the stage's mbarrier.
template <class T, int E>
__device__ __forceinline__ void copy_tile(
    const T* __restrict__ stack, const uint8_t* __restrict__ valid,
    unsigned char* stage, uint32_t bar, int S, int n_elem, int n_pix, int B,
    int vb, int e0, int lane) {
  constexpr int kRowBytes = E * sizeof(T);
  const int vb0 = (e0 / B) & ~15;
  const int vbytes = min(vb, n_pix - vb0);
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(S * (kRowBytes + vbytes)) : "memory");
  __syncwarp();
#pragma unroll 1
  for (int s = lane; s < S; s += 32)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(stage + s * kRowBytes)), "l"(stack + s * n_elem + e0),
           "r"(kRowBytes), "r"(bar) : "memory");
#pragma unroll 1
  for (int s = lane; s < S; s += 32)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(stage + S * kRowBytes + s * vb)),
           "l"(valid + s * n_pix + vb0), "r"(vbytes), "r"(bar) : "memory");
}

// Persistent blocks, each walking tiles of E = 128 * V elements: warp 0
// copies tile i + K into stage (i + K) % K of shared memory while the
// block sorts tile i from its stage, so the copies of K tiles are in
// flight whatever the sort holds in registers. The last, partial tile is
// read directly from device memory by the block whose turn it is.
template <class L, int N, int V>
__global__ void __launch_bounds__(kThreads)
masked_median_staged(const typename L::T* __restrict__ stack,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ med, uint8_t* __restrict__ any_valid,
                     int S, int n_elem, int n_pix, int B, int K, int vb) {
  using T = typename L::T;
  constexpr int NW = V / L::kPer;
  constexpr int E = kThreads * V;
  constexpr int kRowBytes = E * sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + 128;
  const int stage_bytes = S * (kRowBytes + vb);
  const int tid = threadIdx.x;
  const int n_full = n_elem / E;
  const int n_tiles = (n_elem + E - 1) / E;
  const int my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (tid == 0) {
#pragma unroll 1
    for (int k = 0; k < K; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&bars[k])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 32) {
#pragma unroll 1
    for (int i = 0; i < K && i < my_tiles; ++i) {
      const int t = blockIdx.x + i * gridDim.x;
      if (t < n_full)
        copy_tile<T, E>(stack, valid, stages + i * stage_bytes,
                        smem_u32(&bars[i]), S, n_elem, n_pix, B, vb, t * E,
                        tid);
    }
  }
#pragma unroll 1
  for (int i = 0; i < my_tiles; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    const int e0 = t * E + tid * V;
    uint32_t v[N][NW];
    int cnt[V];
    if (t < n_full) {
      bar_wait(smem_u32(&bars[i % K]), (i / K) & 1);
      const unsigned char* st = stages + (i % K) * stage_bytes;
      const int p0 = e0 / B;
      load_pixels<L, N, V>(reinterpret_cast<const T*>(st) + tid * V, E,
                           st + S * kRowBytes + (p0 - (((t * E) / B) & ~15)),
                           vb, S, B - (e0 - p0 * B), v, cnt);
    } else {
      load_elements<L, N, V>(stack, valid, S, n_elem, n_pix, B, e0, v, cnt);
    }
    finish<L, N, V>(v, cnt, med, any_valid, e0, n_elem, e0 + V <= n_elem);
    __syncthreads();
    const int next = blockIdx.x + (i + K) * gridDim.x;
    if (tid < 32 && i + K < my_tiles && next < n_full)
      copy_tile<T, E>(stack, valid, stages + (i % K) * stage_bytes,
                      smem_u32(&bars[i % K]), S, n_elem, n_pix, B, vb,
                      next * E, tid);
  }
}

template <class L, int N, int V>
cudaError_t launch_width(const void* stack, const void* valid, void* med,
                         void* any_valid, int S, int n_elem, int B,
                         cudaStream_t stream) {
  using T = typename L::T;
  const T* x = static_cast<const T*>(stack);
  const uint8_t* m = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(med);
  uint8_t* q = static_cast<uint8_t*>(any_valid);
  const int n_pix = n_elem / B;
  const auto at = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  // vector loads and stores need every scene's row, and each thread's
  // slice of the outputs, aligned to its size
  const bool vec_ok = n_elem % V == 0 && at(x, V * sizeof(T)) &&
                      at(o, V * sizeof(float) < 16 ? V * sizeof(float) : 16) &&
                      at(q, V);
  // bulk copies need 16-byte-aligned rows of samples and of validity
  if (!(vec_ok && B >= V && at(x, 16) && n_elem * sizeof(T) % 16 == 0 &&
        at(m, 16) && n_pix % 16 == 0)) {
    const int per_block = kThreads * V;
    masked_median_direct<L, N, V>
        <<<(n_elem + per_block - 1) / per_block, kThreads, 0, stream>>>(
            x, m, o, q, S, n_elem, n_pix, B, vec_ok);
    return cudaGetLastError();
  }
  constexpr int E = kThreads * V;
  const int vb = ((E - 1) / B + 17 + 15) & ~15;
  const int stage_bytes = S * (E * (int)sizeof(T) + vb);
  static const cudaError_t attr = cudaFuncSetAttribute(
      masked_median_staged<L, N, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return attr;
  // the most stages (3, 2 or 1) that cost no occupancy: as many blocks
  // fit an SM as with one stage (the registers' limit, at the widest
  // networks the shared memory's)
  int K = 3, per_sm = 0, one = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &one, masked_median_staged<L, N, V>, kThreads, 128 + stage_bytes);
  for (;; --K) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, masked_median_staged<L, N, V>, kThreads,
        128 + K * stage_bytes);
    if (per_sm >= one || K == 1) break;
  }
  const int smem = 128 + K * stage_bytes;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (n_elem + E - 1) / E;
  const int blocks = max(1, min(tiles, max(1, per_sm) * sms));
  masked_median_staged<L, N, V><<<blocks, kThreads, smem, stream>>>(
      x, m, o, q, S, n_elem, n_pix, B, K, vb);
  return cudaGetLastError();
}

// V elements a thread, in `words` registers a scene: wider vectors mean
// fewer, larger loads; these limits are where ptxas still keeps every
// sample in registers (no spills, as the build log shows).
template <class L, int N>
cudaError_t launch_n(const void* stack, const void* valid, void* med,
                     void* any_valid, int S, int n_elem, int B,
                     cudaStream_t st) {
  constexpr int words = N <= (L::kPer == 1 ? 16 : 14) ? 4 : N <= 20 ? 2 : 1;
  return launch_width<L, N, words * L::kPer>(stack, valid, med, any_valid, S,
                                            n_elem, B, st);
}

cudaError_t launch_u16(const void* stack, const void* valid, void* med,
                       void* any_valid, int S, int n_elem, int B,
                       cudaStream_t st) {
#define MM_WIDTH(N)                                                         \
  if (S <= N)                                                               \
  return launch_n<U16, N>(stack, valid, med, any_valid, S, n_elem, B, st)
  MM_WIDTH(1); MM_WIDTH(2); MM_WIDTH(3); MM_WIDTH(4); MM_WIDTH(5);
  MM_WIDTH(6); MM_WIDTH(7); MM_WIDTH(8); MM_WIDTH(9); MM_WIDTH(10);
  MM_WIDTH(11); MM_WIDTH(12); MM_WIDTH(13); MM_WIDTH(14); MM_WIDTH(15);
  MM_WIDTH(16); MM_WIDTH(20); MM_WIDTH(24); MM_WIDTH(32); MM_WIDTH(40);
  MM_WIDTH(48); MM_WIDTH(64); MM_WIDTH(80); MM_WIDTH(96); MM_WIDTH(128);
#undef MM_WIDTH
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(const void* stack, const void* valid, void* med,
                       void* any_valid, int S, int n_elem, int B,
                       cudaStream_t st) {
#define MM_WIDTH(N)                                                         \
  if (S <= N)                                                               \
  return launch_n<F32, N>(stack, valid, med, any_valid, S, n_elem, B, st)
  MM_WIDTH(4); MM_WIDTH(8); MM_WIDTH(16); MM_WIDTH(32); MM_WIDTH(64);
  MM_WIDTH(128);
#undef MM_WIDTH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes, shared with ops/compositing.py: 0 uint16, 1 float32.
extern "C" int masked_median_max_scenes() { return 128; }

// stack (S, n_elem) of dtype; valid (S, n_elem / B) bytes; med (n_elem)
// float32; any_valid (n_elem) bytes. S * n_elem must be below 2^31.
// Returns a cudaError_t (0 = launched).
extern "C" int masked_median_launch(const void* stack, int dtype,
                                    const void* valid, void* med,
                                    void* any_valid, int S,
                                    long long n_elem, int B, void* stream) {
  if (S < 1 || S > masked_median_max_scenes() || B < 1 || n_elem < 1 ||
      n_elem % B != 0 || S * n_elem >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(n_elem);
  switch (dtype) {
    case 0:
      return (int)launch_u16(stack, valid, med, any_valid, S, n, B, st);
    case 1:
      return (int)launch_f32(stack, valid, med, any_valid, S, n, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
