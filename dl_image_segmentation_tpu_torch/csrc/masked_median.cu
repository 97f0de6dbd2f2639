// Masked temporal median over the scene axis, written by hand for Hopper
// (sm_90a). Replaces the Pallas kernel of the JAX package,
// ops/compositing.py:_median_pallas_fn (entry masked_median_pallas).
//
// What it computes, per output element (pixel, band): the n samples whose
// scene is valid at that pixel are ranked; the result is the mean of ranks
// (n-1)/2 and n/2, i.e. (lo + hi) * 0.5f in float32, and 0 where n == 0.
// Invalid samples take the value 3.0e38f so that they rank last, exactly
// as the plain version (ops/compositing.py:masked_median) and the JAX
// reference do. The output is bit-identical to the plain version.
//
// What bounds it on an H100: at the chip path's S = 10 scenes each output
// element reads 10 uint16 samples and 10/B mask bytes and writes 5 bytes
// (~26 bytes) for ~80 compare-exchanges of a 16-wide sorting network:
// device-memory bandwidth (3.35 TB/s) is the bound. At S = 73 (a year of
// Sentinel-2 at a 5-day cadence) the network is 128 wide, ~1.8k
// compare-exchanges per element, and the fp32 ALU rate becomes the bound.
//
// What the design does about it:
// * one thread per output element, reading stack[s * N + n]: neighbouring
//   threads read neighbouring addresses, so every load is coalesced;
// * the stack is read in its source dtype (uint16 from the catalog) and
//   converted in registers, half the bytes of a float32 upload;
// * validity is read as (S, H, W) bytes indexed by n / B, never broadcast
//   over bands (the TPU wrapper broadcast it to (S, H, W*B) float32);
// * the samples live in registers: a bitonic network over a power-of-two
//   width chosen from S at run time (8..128), with every index a
//   compile-time constant, so nothing spills to local memory by indexing;
//   rank selection is a static select loop for the same reason.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (kernels/__init__.py). Plain C interface, called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvalid = 3.0e38f;
constexpr int kThreads = 128;

// Total order of the plain version's sort: NaN ranks above everything.
__device__ __forceinline__ bool greater(float a, float b) {
  return a > b || (a != a && b == b);
}

template <int N>
__device__ __forceinline__ void bitonic_sort(float (&v)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const float a = v[i];
          const float b = v[l];
          const bool swap = ((i & k) == 0) ? greater(a, b) : greater(b, a);
          v[i] = swap ? b : a;
          v[l] = swap ? a : b;
        }
      }
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
masked_median_kernel(const T* __restrict__ stack,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ med, uint8_t* __restrict__ any_valid,
                     int S, long long n_elem, int B) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_elem) return;
  const long long n_pix = n_elem / B;
  const long long pix = idx / B;
  float v[N];
  int n = 0;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    float x = kInvalid;
    if (s < S && valid[s * n_pix + pix] != 0) {
      x = static_cast<float>(stack[s * n_elem + idx]);
      ++n;
    }
    v[s] = x;
  }
  bitonic_sort<N>(v);
  const int nz = n > 1 ? n : 1;
  const int lo_idx = (nz - 1) / 2;
  const int hi_idx = nz / 2;
  float lo = 0.f;
  float hi = 0.f;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    lo = (s == lo_idx) ? v[s] : lo;
    hi = (s == hi_idx) ? v[s] : hi;
  }
  med[idx] = n > 0 ? __fmul_rn(__fadd_rn(lo, hi), 0.5f) : 0.f;
  any_valid[idx] = n > 0 ? 1 : 0;
}

template <typename T>
cudaError_t launch_typed(const void* stack, const void* valid, void* med,
                         void* any_valid, int S, long long n_elem, int B,
                         cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_elem + kThreads - 1) / kThreads);
  const T* x = static_cast<const T*>(stack);
  const uint8_t* m = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(med);
  uint8_t* a = static_cast<uint8_t*>(any_valid);
#define MM_LAUNCH(N)                                                  \
  masked_median_kernel<T, N><<<blocks, kThreads, 0, stream>>>(        \
      x, m, o, a, S, n_elem, B)
  if (S <= 8) MM_LAUNCH(8);
  else if (S <= 16) MM_LAUNCH(16);
  else if (S <= 32) MM_LAUNCH(32);
  else if (S <= 64) MM_LAUNCH(64);
  else MM_LAUNCH(128);
#undef MM_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype codes, shared with ops/compositing.py: 0 uint16, 1 float32.
extern "C" int masked_median_max_scenes() { return 128; }

// stack (S, n_elem) of dtype; valid (S, n_elem / B) bytes; med (n_elem)
// float32; any_valid (n_elem) bytes. Returns a cudaError_t (0 = launched).
extern "C" int masked_median_launch(const void* stack, int dtype,
                                    const void* valid, void* med,
                                    void* any_valid, int S,
                                    long long n_elem, int B, void* stream) {
  if (S < 1 || S > masked_median_max_scenes() || B < 1 || n_elem < 1 ||
      n_elem % B != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_typed<uint16_t>(stack, valid, med, any_valid, S,
                                         n_elem, B, st);
    case 1:
      return (int)launch_typed<float>(stack, valid, med, any_valid, S,
                                      n_elem, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
