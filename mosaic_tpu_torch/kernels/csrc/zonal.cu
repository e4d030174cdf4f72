// Zonal statistics kernels for Hopper (sm_90a), bound to Python by ctypes.
//
// zonal_tiled — replaces mosaic_tpu/kernels/zonal.py zonal_tiled
//   (_zonal_kernel). f32 count, sum, min and max of pixel values grouped
//   by segment id; a segment id outside [0, S) folds nowhere; an empty
//   segment reports count 0, sum 0, min 1e30, max -1e30. The Pallas grid
//   is (segment blocks x pixel blocks) with a one-hot compare and carries
//   each accumulator block across the sequential pixel axis. Blocks on
//   this card run in no order, so the fold is two passes with a fixed
//   order and no atomics:
//     pass 1 (zonal_tiled_partial_kernel): grid (pixel chunks of tile_n,
//       segment blocks of tile_s). The block stages its chunk's segment
//       ids and values in shared memory, 1024 pixels at a time; each
//       thread owns one segment and scans the staged pixels in pixel
//       order, so each (chunk, segment) partial is a sequential fold.
//     pass 2 (zonal_tiled_merge_kernel): one thread per segment folds the
//       partials over the chunks in chunk order.
//   The sum accumulates in f64 (from f32 values, each add rounded to
//   nearest) and is rounded to f32 once, so the f32 result is the one
//   nearest the exact sum to within the f64 error, whatever the order:
//   a sequential f32 sum of the ~10**4 pixels a zone holds in one tile
//   moves by ~3e-6 of its size with the order. Counts are f32, exact to
//   2**24, as in the reference.
//   Bound on this card: bytes — 8 bytes per pixel in, 16 per segment out
//   — but this simple design compares every pixel with every segment of
//   its block (N x S compares, from shared memory as warp broadcasts), so
//   it runs far above that bound at S in the hundreds.
//
// zonal_seq_fold — the CUDA lane of kernels/zonal.py zonal_fold (a jnp
//   segment reduce in the reference, not a Pallas kernel). Its contract
//   is that each segment's sum is accumulated sequentially in pixel order
//   (the f64 bit-identity contract with the host oracle). The wrapper
//   sorts the pixels by segment with a stable sort, so each segment's
//   pixels are one run in pixel order; one thread per segment walks its
//   run. Templated on the accumulator type (float or double).
//
// Floating point: sums use the round-to-nearest intrinsics (__fadd_rn,
// __dadd_rn), which nvcc never contracts, and the library builds with
// -fmad=false. min and max propagate NaN, like torch's amin/amax.
//
// Each C entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;    // threads per block; one segment each
constexpr int kStage = 1024;     // pixels staged in shared memory per step
constexpr float kBig = 1e30f;    // inert min/max fill of the reference

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// NaN-propagating min/max: a NaN seen once stays
template <typename T>
__device__ __forceinline__ T nan_min(T acc, T v) {
  return (v < acc || v != v) ? v : acc;
}
template <typename T>
__device__ __forceinline__ T nan_max(T acc, T v) {
  return (v > acc || v != v) ? v : acc;
}

__global__ void __launch_bounds__(kThreads)
zonal_tiled_partial_kernel(const float* __restrict__ vals,
                           const int* __restrict__ seg, long long n, int S,
                           int tile_n, int tile_s, float* __restrict__ pcnt,
                           double* __restrict__ psum, float* __restrict__ pmin,
                           float* __restrict__ pmax) {
  __shared__ int sseg[kStage];
  __shared__ float sval[kStage];
  const long long chunk = blockIdx.x;
  const long long p0 = chunk * (long long)tile_n;
  const long long p1 = min(p0 + (long long)tile_n, n);
  const int s0 = blockIdx.y * tile_s;
  for (int j = 0; j < tile_s; j += kThreads) {  // uniform over the block
    const int s = s0 + j + threadIdx.x;
    float c = 0.0f, mn = kBig, mx = -kBig;
    double sum = 0.0;
    for (long long b = p0; b < p1; b += kStage) {  // uniform over the block
      const int m = (int)min((long long)kStage, p1 - b);
      __syncthreads();  // the previous stage is fully read
      for (int t = threadIdx.x; t < m; t += kThreads) {
        sseg[t] = seg[b + t];
        sval[t] = vals[b + t];
      }
      __syncthreads();
      for (int i = 0; i < m; ++i) {
        if (sseg[i] == s) {
          const float v = sval[i];
          c = __fadd_rn(c, 1.0f);
          sum = __dadd_rn(sum, (double)v);
          mn = nan_min(mn, v);
          mx = nan_max(mx, v);
        }
      }
    }
    if (s < S) {  // tile_s is a multiple of kThreads (the wrapper checks)
      const size_t o = (size_t)chunk * (size_t)S + (size_t)s;
      pcnt[o] = c;
      psum[o] = sum;
      pmin[o] = mn;
      pmax[o] = mx;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
zonal_tiled_merge_kernel(const float* __restrict__ pcnt,
                         const double* __restrict__ psum,
                         const float* __restrict__ pmin,
                         const float* __restrict__ pmax, long long n_chunks,
                         int S, int* __restrict__ cnt, float* __restrict__ sum,
                         float* __restrict__ mn, float* __restrict__ mx) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float c = 0.0f, lo = kBig, hi = -kBig;
  double sm = 0.0;
  for (long long k = 0; k < n_chunks; ++k) {  // chunk order: fixed
    const size_t o = (size_t)k * (size_t)S + (size_t)s;
    c = __fadd_rn(c, pcnt[o]);
    sm = __dadd_rn(sm, psum[o]);
    lo = nan_min(lo, pmin[o]);
    hi = nan_max(hi, pmax[o]);
  }
  cnt[s] = (int)c;
  sum[s] = __double2float_rn(sm);
  mn[s] = lo;
  mx[s] = hi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
zonal_seq_fold_kernel(const T* __restrict__ sorted_vals,
                      const long long* __restrict__ starts,
                      const long long* __restrict__ counts, int S,
                      int* __restrict__ cnt, T* __restrict__ sum,
                      T* __restrict__ mn, T* __restrict__ mx) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const long long a = starts[s], m = counts[s];
  T acc = T(0), lo = T(CUDART_INF), hi = -T(CUDART_INF);
  for (long long i = 0; i < m; ++i) {  // pixel order within the segment
    const T v = sorted_vals[a + i];
    acc = add_rn(acc, v);
    lo = nan_min(lo, v);
    hi = nan_max(hi, v);
  }
  cnt[s] = (int)m;
  sum[s] = acc;
  mn[s] = lo;
  mx[s] = hi;
}

template <typename T>
int launch_seq_fold(const T* sorted_vals, const long long* starts,
                    const long long* counts, int S, int* cnt, T* sum, T* mn,
                    T* mx, void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  zonal_seq_fold_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sorted_vals, starts, counts, S, cnt, sum, mn, mx);
  return (int)cudaGetLastError();
}

}  // namespace

// partials: 3 planes of n_chunks x S floats (count, min, max); psum:
// n_chunks x S doubles; n_chunks = ceil(n / tile_n); n >= 1 and S >= 1
extern "C" int mosaic_zonal_tiled(const float* vals, const int* seg,
                                  long long n, int S, int tile_n, int tile_s,
                                  float* partials, double* psum, int* cnt,
                                  float* sum, float* mn, float* mx,
                                  void* stream) {
  const long long n_chunks = (n + tile_n - 1) / tile_n;
  const size_t plane = (size_t)n_chunks * (size_t)S;
  const dim3 grid((unsigned int)n_chunks, (unsigned int)((S + tile_s - 1) / tile_s));
  zonal_tiled_partial_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      vals, seg, n, S, tile_n, tile_s, partials, psum, partials + plane,
      partials + 2 * plane);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  zonal_tiled_merge_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0,
                             (cudaStream_t)stream>>>(
      partials, psum, partials + plane, partials + 2 * plane, n_chunks, S,
      cnt, sum, mn, mx);
  return (int)cudaGetLastError();
}

extern "C" int mosaic_zonal_seq_fold_f32(const float* sorted_vals,
                                         const long long* starts,
                                         const long long* counts, int S,
                                         int* cnt, float* sum, float* mn,
                                         float* mx, void* stream) {
  return launch_seq_fold<float>(sorted_vals, starts, counts, S, cnt, sum, mn,
                                mx, stream);
}

extern "C" int mosaic_zonal_seq_fold_f64(const double* sorted_vals,
                                         const long long* starts,
                                         const long long* counts, int S,
                                         int* cnt, double* sum, double* mn,
                                         double* mx, void* stream) {
  return launch_seq_fold<double>(sorted_vals, starts, counts, S, cnt, sum, mn,
                                 mx, stream);
}
