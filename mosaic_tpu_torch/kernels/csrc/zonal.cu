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
//       segment blocks of tile_s). Each warp reads 32 pixels at a time,
//       coalesced; lanes with the same segment are grouped with
//       __match_any_sync and each group is folded by its leader, in lane
//       order (a whole-warp group by a shuffle tree), into accumulators in
//       shared memory that belong to that warp alone. The block then folds
//       its warps' accumulators in warp order into one partial per
//       (segment, chunk). Each pixel is read once per segment block of
//       kSub segments: O(tile_n) work per chunk, not O(tile_n x tile_s).
//     pass 2 (zonal_tiled_merge_kernel): one warp per segment folds the
//       partials over the chunks, each lane a fixed stride of chunks, then
//       a fixed shuffle tree. It writes every output, empty segments too.
//   The sum accumulates in f64 (from f32 values, each add rounded to
//   nearest) and is rounded to f32 once, so the f32 result is the one
//   nearest the exact sum to within the f64 error, whatever the order.
//   The order is a function of the inputs alone, so two calls on the same
//   inputs return the same bits.
//   Bound on this card: bytes — 8 bytes per pixel in, 16 per segment out.
//
// zonal_seq_fold — the CUDA lane of kernels/zonal.py zonal_fold (a jnp
//   segment reduce in the reference, not a Pallas kernel). Its contract:
//   count, min, max and each segment's sum equal, bit for bit, a
//   sequential fold in pixel order as torch's CPU index_add_ /
//   scatter_reduce_ compute it (the f64 bit-identity contract with the
//   host oracle). The wrapper sorts the pixels by segment with a stable
//   sort, so each segment's pixels are one run in pixel order, and passes
//   the inclusive prefix sum of the run lengths. One block per segment:
//     - all threads read the run coalesced and reduce count, min, max
//       (a tie resolves to the first element in pixel order; a NaN makes
//       min and max the last NaN, as the CPU lane does), a tree sum, and
//       the exact-sum test below;
//     - exact branch: no NaN, no inf, no -0.0, and m * M <= 2^(p+e) with
//       p + e <= emax, where e is the exponent of the lowest set bit over
//       the run's values, M their largest magnitude, m the run length and
//       p the accumulator's precision (53 or 24). Every partial sum in any
//       order is then a multiple of 2^e no larger than 2^(p+e), so every
//       add is exact and the tree sum is the sequential sum. Integer
//       rasters (int16/uint16 values) always take it;
//     - sequential branch, every other run: warps 1.. stage the run in
//       shared memory, two buffers in turn, while lane 0 of warp 0 walks
//       it with a dependent __dadd_rn (__fadd_rn) chain in pixel order, so
//       the chain waits on the add, not on device memory. A NaN sum takes
//       the bits the CPU's add gives: the last NaN of the run, quieted, or
//       the default NaN when inf and -inf met.
//   Bound on this card: bytes, or the longest sequential-branch run times
//   one dependent add's latency, whichever is larger.
//
// Floating point: sums use the round-to-nearest intrinsics (__fadd_rn,
// __dadd_rn), which nvcc never contracts, and the library builds with
// -fmad=false. min and max propagate NaN, like torch's amin/amax.
//
// Each C entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTiledThreads = 256;  // zonal_tiled: 8 warps a block
constexpr int kTiledWarps = kTiledThreads / 32;
constexpr int kSub = 256;           // segments held in shared memory at once
constexpr int kFoldThreads = 512;   // zonal_seq_fold: one block a segment
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kBatch = 8;           // zonal_seq_fold: loads a thread issues at once
constexpr int kStageBytes = 16384;  // one staging buffer of the walk
constexpr float kBig = 1e30f;       // inert min/max fill of the reference

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// NaN-propagating min/max: a NaN seen once stays (the last NaN seen wins)
template <typename T>
__device__ __forceinline__ T nan_min(T acc, T v) {
  return (v < acc || v != v) ? v : acc;
}
template <typename T>
__device__ __forceinline__ T nan_max(T acc, T v) {
  return (v > acc || v != v) ? v : acc;
}

// ------------------------------------------------------------ zonal_tiled

__global__ void __launch_bounds__(kTiledThreads)
zonal_tiled_partial_kernel(const float* __restrict__ vals,
                           const int* __restrict__ seg, long long n, int S,
                           int tile_n, int tile_s, long long n_chunks,
                           int* __restrict__ pcnt, double* __restrict__ psum,
                           float* __restrict__ pmin, float* __restrict__ pmax) {
  __shared__ int acnt[kTiledWarps][kSub];
  __shared__ double asum[kTiledWarps][kSub];
  __shared__ float amin[kTiledWarps][kSub];
  __shared__ float amax[kTiledWarps][kSub];
  __shared__ float sval[kTiledWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long chunk = blockIdx.x;
  const long long p0 = chunk * (long long)tile_n;
  const long long p1 = min(p0 + (long long)tile_n, n);
  const int s_begin = blockIdx.y * tile_s;
  const int s_end = min(s_begin + tile_s, S);
  for (int sb = s_begin; sb < s_end; sb += kSub) {  // uniform over the block
    const int ns = min(kSub, s_end - sb);
    __syncthreads();  // the previous segment block's accumulators are read
    for (int i = threadIdx.x; i < kTiledWarps * kSub; i += kTiledThreads) {
      const int w = i / kSub, j = i % kSub;
      acnt[w][j] = 0;
      asum[w][j] = 0.0;
      amin[w][j] = kBig;
      amax[w][j] = -kBig;
    }
    __syncthreads();
    // warp w reads pixels p0 + 32 w + 256 k + lane, the next batch's
    // loads in flight while this one folds; uniform over the warp
    long long base = p0 + 32 * warp;
    int sg_next = -1;
    float v_next = 0.0f;
    if (base + lane < p1) {
      sg_next = seg[base + lane];
      v_next = vals[base + lane];
    }
    for (; base < p1; base += kTiledThreads) {
      const int sg = sg_next;
      const float v = v_next;
      const long long pn = base + kTiledThreads + lane;
      sg_next = -1;
      if (pn < p1) {
        sg_next = seg[pn];
        v_next = vals[pn];
      }
      const int key = (sg >= sb && sg < sb + ns) ? sg - sb : -1;
      const unsigned group = __match_any_sync(kFull, key);
      if (group == kFull) {  // one segment (or none) for the whole warp
        if (key >= 0) {
          double sm = (double)v;
          float lo = v, hi = v;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            sm = __dadd_rn(sm, __shfl_xor_sync(kFull, sm, off));
            lo = nan_min(lo, __shfl_xor_sync(kFull, lo, off));
            hi = nan_max(hi, __shfl_xor_sync(kFull, hi, off));
          }
          if (lane == 0) {
            acnt[warp][key] += 32;
            asum[warp][key] = __dadd_rn(asum[warp][key], sm);
            amin[warp][key] = nan_min(amin[warp][key], lo);
            amax[warp][key] = nan_max(amax[warp][key], hi);
          }
        }
      } else {
        sval[warp][lane] = v;
        __syncwarp();
        if (key >= 0 && lane == __ffs(group) - 1) {  // the group's leader
          double sm = 0.0;
          float lo = kBig, hi = -kBig;
          for (unsigned g = group; g; g &= g - 1) {  // lane order
            const float x = sval[warp][__ffs(g) - 1];
            sm = __dadd_rn(sm, (double)x);
            lo = nan_min(lo, x);
            hi = nan_max(hi, x);
          }
          acnt[warp][key] += __popc(group);
          asum[warp][key] = __dadd_rn(asum[warp][key], sm);
          amin[warp][key] = nan_min(amin[warp][key], lo);
          amax[warp][key] = nan_max(amax[warp][key], hi);
        }
        __syncwarp();  // sval is read before the next batch overwrites it
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < ns; j += kTiledThreads) {
      int c = 0;
      double sm = 0.0;
      float lo = kBig, hi = -kBig;
      for (int w = 0; w < kTiledWarps; ++w) {  // warp order: fixed
        c += acnt[w][j];
        sm = __dadd_rn(sm, asum[w][j]);
        lo = nan_min(lo, amin[w][j]);
        hi = nan_max(hi, amax[w][j]);
      }
      const size_t o = (size_t)(sb + j) * (size_t)n_chunks + (size_t)chunk;
      pcnt[o] = c;
      psum[o] = sm;
      pmin[o] = lo;
      pmax[o] = hi;
    }
  }
}

__global__ void __launch_bounds__(kTiledThreads)
zonal_tiled_merge_kernel(const int* __restrict__ pcnt,
                         const double* __restrict__ psum,
                         const float* __restrict__ pmin,
                         const float* __restrict__ pmax, long long n_chunks,
                         int S, int* __restrict__ cnt, float* __restrict__ sum,
                         float* __restrict__ mn, float* __restrict__ mx) {
  const int s = blockIdx.x * kTiledWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= S) return;  // uniform over the warp
  int c = 0;
  double sm = 0.0;
  float lo = kBig, hi = -kBig;
  const size_t row = (size_t)s * (size_t)n_chunks;
  for (long long k = lane; k < n_chunks; k += 32) {  // fixed stride per lane
    c += pcnt[row + k];
    sm = __dadd_rn(sm, psum[row + k]);
    lo = nan_min(lo, pmin[row + k]);
    hi = nan_max(hi, pmax[row + k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {  // fixed tree
    c += __shfl_xor_sync(kFull, c, off);
    sm = __dadd_rn(sm, __shfl_xor_sync(kFull, sm, off));
    lo = nan_min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if (lane == 0) {
    cnt[s] = c;
    sum[s] = __double2float_rn(sm);
    mn[s] = lo;
    mx[s] = hi;
  }
}

// --------------------------------------------------------- zonal_seq_fold

// IEEE traits of the accumulator: precision p, largest exponent, the bit
// pattern, the exponent of the lowest set bit of a finite nonzero value,
// the quiet bit and the default NaN of an x86 add.
template <typename T> struct Fp;
template <> struct Fp<double> {
  using U = unsigned long long;
  static constexpr int kP = 53, kEmax = 1023;
  static constexpr U kSign = 0x8000000000000000ull;
  static constexpr U kQuiet = 0x0008000000000000ull;
  static constexpr U kDefaultNan = 0xfff8000000000000ull;
  __device__ static U bits(double v) { return (U)__double_as_longlong(v); }
  __device__ static double from(U u) { return __longlong_as_double((long long)u); }
  __device__ static int low_exp(double v) {
    const U u = bits(v) & ~kSign;
    const int ef = (int)(u >> 52);
    const U frac = u & ((1ull << 52) - 1);
    const U mant = ef ? (frac | (1ull << 52)) : frac;
    return (ef ? ef - 1075 : -1074) + __ffsll((long long)mant) - 1;
  }
};
template <> struct Fp<float> {
  using U = unsigned int;
  static constexpr int kP = 24, kEmax = 127;
  static constexpr U kSign = 0x80000000u;
  static constexpr U kQuiet = 0x00400000u;
  static constexpr U kDefaultNan = 0xffc00000u;
  __device__ static U bits(float v) { return __float_as_uint(v); }
  __device__ static float from(U u) { return __uint_as_float(u); }
  __device__ static int low_exp(float v) {
    const U u = bits(v) & ~kSign;
    const int ef = (int)(u >> 23);
    const U frac = u & ((1u << 23) - 1);
    const U mant = ef ? (frac | (1u << 23)) : frac;
    return (ef ? ef - 150 : -149) + __ffs((int)mant) - 1;
  }
};

template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int off) {
  return __shfl_xor_sync(kFull, v, off);
}

template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
zonal_seq_fold_kernel(const T* __restrict__ sorted_vals,
                      const long long* __restrict__ ends, int S,
                      int* __restrict__ cnt, T* __restrict__ sum,
                      T* __restrict__ mn, T* __restrict__ mx) {
  using F = Fp<T>;
  constexpr int kStage = kStageBytes / (int)sizeof(T);
  __shared__ __align__(16) T stage[2][kStage];
  __shared__ T r_sum[kFoldWarps], r_lo[kFoldWarps], r_hi[kFoldWarps], r_abs[kFoldWarps];
  __shared__ int r_e[kFoldWarps], r_bad[kFoldWarps];
  __shared__ long long r_nan[kFoldWarps], r_zero[kFoldWarps];
  __shared__ int exact;
  const int s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long a = s ? ends[s - 1] : 0;
  const long long m = ends[s] - a;
  const T* __restrict__ run = sorted_vals + a;

  // 1. count, min, max, tree sum and the exact-sum test, all threads
  T tsum = T(0), lo = T(CUDART_INF), hi = -T(CUDART_INF), big = T(0);
  int emin = INT_MAX, bad = 0;
  long long last_nan = -1;        // index of the last NaN
  long long first_zero = LLONG_MAX;  // 2 * index + sign of the first zero
  // kBatch loads in flight per thread: a long run is load latency
  for (long long i0 = tid; i0 < m; i0 += kBatch * kFoldThreads) {
    T x[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const long long i = i0 + (long long)q * kFoldThreads;
      x[q] = i < m ? run[i] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const long long i = i0 + (long long)q * kFoldThreads;
      const T v = x[q];
      if (i >= m) break;
      if (v != v) {
        bad = 1;
        last_nan = max(last_nan, i);
        continue;
      }
      lo = v < lo ? v : lo;
      hi = v > hi ? v : hi;
      tsum = add_rn(tsum, v);
      if (v == T(0)) {
        const int neg = (F::bits(v) & F::kSign) ? 1 : 0;
        first_zero = min(first_zero, 2 * i + neg);
        bad |= neg;
      } else if (isinf(v)) {
        bad = 1;
      } else {
        big = max(big, fabs(v));
        emin = min(emin, F::low_exp(v));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    tsum = add_rn(tsum, shfl_xor(tsum, off));
    const T l2 = shfl_xor(lo, off), h2 = shfl_xor(hi, off);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
    big = max(big, shfl_xor(big, off));
    emin = min(emin, shfl_xor(emin, off));
    bad |= shfl_xor(bad, off);
    last_nan = max(last_nan, shfl_xor(last_nan, off));
    first_zero = min(first_zero, shfl_xor(first_zero, off));
  }
  if (lane == 0) {
    r_sum[warp] = tsum; r_lo[warp] = lo; r_hi[warp] = hi; r_abs[warp] = big;
    r_e[warp] = emin; r_bad[warp] = bad; r_nan[warp] = last_nan;
    r_zero[warp] = first_zero;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kFoldWarps; ++w) {
      tsum = add_rn(tsum, r_sum[w]);
      lo = r_lo[w] < lo ? r_lo[w] : lo;
      hi = r_hi[w] > hi ? r_hi[w] : hi;
      big = max(big, r_abs[w]);
      emin = min(emin, r_e[w]);
      bad |= r_bad[w];
      last_nan = max(last_nan, r_nan[w]);
      first_zero = min(first_zero, r_zero[w]);
    }
    int ok = !bad;
    if (ok && emin != INT_MAX) {  // some nonzero value: test m * M <= 2^(p+e)
      const double k = ldexp((double)big, -emin);  // M / 2^e, an integer
      const unsigned long long lim = 1ull << F::kP;
      ok = F::kP + emin <= F::kEmax && k <= (double)lim &&
           (unsigned long long)k <= lim / (unsigned long long)m;
    }
    exact = ok;
  }
  __syncthreads();

  // 2. the sequential branch: warps 1.. stage, lane 0 of warp 0 walks
  if (!exact) {  // uniform over the block
    T acc = T(0);
    for (int j = tid; j < kStage && j < m; j += kFoldThreads) stage[0][j] = run[j];
    for (long long b = 0, c = 0; b < m; b += kStage, ++c) {
      __syncthreads();  // stage c is loaded, stage c - 1 is walked
      if (warp == 0) {
        if (lane == 0) {
          const T* p = stage[c & 1];
          const int len = (int)min((long long)kStage, m - b);
          int j = 0;
          for (; j + 8 <= len; j += 8) {
            T x[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) x[q] = p[j + q];
#pragma unroll
            for (int q = 0; q < 8; ++q) acc = add_rn(acc, x[q]);
          }
          for (; j < len; ++j) acc = add_rn(acc, p[j]);
        }
      } else {
        const long long nb = b + kStage;
        T* q = stage[(c + 1) & 1];
        const long long len = min((long long)kStage, m - nb);
        for (long long j = tid - 32; j < len; j += kFoldThreads - 32) q[j] = run[nb + j];
      }
    }
    if (tid == 0) {
      if (acc != acc) {  // the CPU add's NaN: last NaN quieted, else default
        acc = last_nan >= 0 ? F::from(F::bits(run[last_nan]) | F::kQuiet)
                            : F::from(F::kDefaultNan);
      }
      tsum = acc;
    }
  }

  if (tid == 0) {
    if (last_nan >= 0) {
      lo = hi = run[last_nan];
    } else if (first_zero != LLONG_MAX) {  // a tie at zero: the first zero
      const T z = (first_zero & 1) ? -T(0) : T(0);
      if (lo == T(0)) lo = z;
      if (hi == T(0)) hi = z;
    }
    cnt[s] = (int)m;
    sum[s] = tsum;
    mn[s] = lo;
    mx[s] = hi;
  }
}

template <typename T>
int launch_seq_fold(const T* sorted_vals, const long long* ends, int S,
                    int* cnt, T* sum, T* mn, T* mx, void* stream) {
  zonal_seq_fold_kernel<T><<<S, kFoldThreads, 0, (cudaStream_t)stream>>>(
      sorted_vals, ends, S, cnt, sum, mn, mx);
  return (int)cudaGetLastError();
}

// a chain of n dependent adds on one thread: the latency of one add
__global__ void dadd_chain_kernel(double x, double step, int n,
                                  double* __restrict__ out,
                                  long long* __restrict__ cycles) {
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = __dadd_rn(x, step);
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}

}  // namespace

// scratch: n_chunks x S partials, laid out (segment, chunk): f64 sums,
// then i32 counts, f32 mins, f32 maxes; n_chunks = ceil(n / tile_n);
// n >= 1 and S >= 1. Writes all S outputs.
extern "C" int mosaic_zonal_tiled(const float* vals, const int* seg,
                                  long long n, int S, int tile_n, int tile_s,
                                  void* scratch, int* cnt, float* sum,
                                  float* mn, float* mx, void* stream) {
  const long long n_chunks = (n + tile_n - 1) / tile_n;
  const size_t plane = (size_t)n_chunks * (size_t)S;
  double* psum = (double*)scratch;
  int* pcnt = (int*)(psum + plane);
  float* pmin = (float*)(pcnt + plane);
  float* pmax = pmin + plane;
  const dim3 grid((unsigned int)n_chunks, (unsigned int)((S + tile_s - 1) / tile_s));
  zonal_tiled_partial_kernel<<<grid, kTiledThreads, 0, (cudaStream_t)stream>>>(
      vals, seg, n, S, tile_n, tile_s, n_chunks, pcnt, psum, pmin, pmax);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  zonal_tiled_merge_kernel<<<(S + kTiledWarps - 1) / kTiledWarps, kTiledThreads,
                             0, (cudaStream_t)stream>>>(
      pcnt, psum, pmin, pmax, n_chunks, S, cnt, sum, mn, mx);
  return (int)cudaGetLastError();
}

// ends: the inclusive prefix sum of the S run lengths of sorted_vals
extern "C" int mosaic_zonal_seq_fold_f32(const float* sorted_vals,
                                         const long long* ends, int S,
                                         int* cnt, float* sum, float* mn,
                                         float* mx, void* stream) {
  return launch_seq_fold<float>(sorted_vals, ends, S, cnt, sum, mn, mx, stream);
}

extern "C" int mosaic_zonal_seq_fold_f64(const double* sorted_vals,
                                         const long long* ends, int S,
                                         int* cnt, double* sum, double* mn,
                                         double* mx, void* stream) {
  return launch_seq_fold<double>(sorted_vals, ends, S, cnt, sum, mn, mx, stream);
}

// one thread adds step to x n times in a dependent chain; out[0] gets the
// result, cycles[0] the SM clock cycles the chain took
extern "C" int mosaic_dadd_chain(double x, double step, int n, double* out,
                                 long long* cycles, void* stream) {
  dadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x, step, n, out, cycles);
  return (int)cudaGetLastError();
}
