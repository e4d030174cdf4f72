// Point-in-polygon kernels for Hopper (sm_90a), bound to Python by ctypes.
//
// Two kernels, each replacing one Pallas TPU kernel of the JAX package:
//
// pip_zone_kernel  — replaces mosaic_tpu/kernels/pip.py pip_zone
//   (_pip_zone_kernel). Brute force with no index: for every point, the
//   smallest polygon id gid < n_real_g whose even-odd crossing count is
//   odd, else -1. Bound on this card: f32 operations, about 8 per
//   (point, polygon slot, edge) crossing test — the edge planes are a few
//   hundred KB and are re-read from shared memory, not device memory.
//   Design: one thread per point; the block stages a 64-edge x 32-polygon
//   tile of (ax, ay, by, slope) in shared memory (32 KB, one float4 per
//   pair, read as a broadcast by the whole warp), computing each edge's
//   slope once per block; every thread keeps 32 crossing counters in
//   registers for the polygon tile it walks.
//
// pip_heavy_kernel — replaces mosaic_tpu/kernels/pip.py pip_heavy_tiled
//   (_pip_heavy_kernel). For each compacted heavy-lane point, XOR the slot
//   bit of every edge of ITS OWN heavy row that the +x ray crosses; best =
//   the smallest slot geom >= 0 with odd parity (INT32_MAX when none or
//   when the row is -1); optionally `near` = within sqrt(eps2) of a real
//   edge. Bound on this card: the work is tiny (K points x E2 edges); a
//   launch is latency-bound, and the ~3 MB heavy tables sit in the 50 MB
//   L2. Design: one thread per point reads only its own row (the TPU
//   kernel swept every row for every point block and masked), straight
//   from global memory through L2 — the tables exceed shared memory.
//   Rows are int32 and slot bits uint32, as in the reference kernel.
//
// Floating point: every operation is written with the round-to-nearest
// intrinsics (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), which nvcc never
// contracts into FMAs, and the library builds with -fmad=false as well, so
// each kernel is bit-identical to its plain torch version. pip_zone divides
// once per edge (slope) and pip_heavy multiplies then divides — the two
// reference kernels round differently and each port keeps its own order.
//
// Each C entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kZoneTileE = 64;   // edges per shared-memory stage
constexpr int kZoneTileG = 32;   // polygons per shared-memory stage
constexpr int kZoneThreads = 256;
constexpr int kHeavyThreads = 128;
constexpr float kBig = 1e30f;    // degenerate pad edge: ay == by == 1e30

__global__ void __launch_bounds__(kZoneThreads)
pip_zone_kernel(const float2* __restrict__ pts, long long n,
                const float* __restrict__ planes, int E, int G,
                int n_real_g, int* __restrict__ out) {
  __shared__ float4 tile[kZoneTileE][kZoneTileG];
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  float px = kBig, py = kBig;
  if (i < n) {
    const float2 p = pts[i];
    px = p.x;
    py = p.y;
  }
  const size_t plane = (size_t)E * (size_t)G;
  int best = INT_MAX;
  for (int g0 = 0; g0 < G; g0 += kZoneTileG) {
    int cnt[kZoneTileG];
#pragma unroll
    for (int g = 0; g < kZoneTileG; ++g) cnt[g] = 0;
    for (int e0 = 0; e0 < E; e0 += kZoneTileE) {
      __syncthreads();  // the previous stage is fully read
      for (int t = threadIdx.x; t < kZoneTileE * kZoneTileG; t += blockDim.x) {
        const int e = t / kZoneTileG, g = t % kZoneTileG;
        const int ge = e0 + e, gg = g0 + g;
        float ax = 0.0f, ay = kBig, bx = 0.0f, by = kBig;
        if (ge < E && gg < G) {
          const size_t o = (size_t)ge * G + gg;
          ax = planes[o];
          ay = planes[plane + o];
          bx = planes[2 * plane + o];
          by = planes[3 * plane + o];
        }
        const float denom = (by == ay) ? 1.0f : __fsub_rn(by, ay);
        const float slope = __fdiv_rn(__fsub_rn(bx, ax), denom);
        tile[e][g] = make_float4(ax, ay, by, slope);
      }
      __syncthreads();
      for (int e = 0; e < kZoneTileE; ++e) {
#pragma unroll
        for (int g = 0; g < kZoneTileG; ++g) {
          const float4 s = tile[e][g];  // ax, ay, by, slope
          const bool straddle = (s.y > py) != (s.z > py);
          const float xc = __fadd_rn(s.x, __fmul_rn(__fsub_rn(py, s.y), s.w));
          cnt[g] += (straddle && px < xc) ? 1 : 0;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kZoneTileG; ++g) {
      const int gid = g0 + g;
      if ((cnt[g] & 1) && gid < n_real_g && gid < best) best = gid;
    }
  }
  if (i < n) out[i] = (best == INT_MAX) ? -1 : best;
}

__global__ void __launch_bounds__(kHeavyThreads)
pip_heavy_kernel(const float* __restrict__ px_, const float* __restrict__ py_,
                 const int* __restrict__ rows, long long K,
                 const float4* __restrict__ edges,
                 const unsigned int* __restrict__ bits,
                 const int* __restrict__ geom, int E2, int M2, float eps2,
                 int banded, int* __restrict__ best_out,
                 unsigned char* __restrict__ near_out) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long long row = rows[k];  // widened: row * E2 may pass 2^31
  int best = INT_MAX;
  int near = 0;
  if (row >= 0) {
    const float px = px_[k], py = py_[k];
    const float4* er = edges + row * E2;
    const unsigned int* br = bits + row * E2;
    unsigned int par = 0u;
    for (int e = 0; e < E2; ++e) {
      const float4 ed = er[e];
      const unsigned int b = br[e];
      const float ax = ed.x, ay = ed.y, bx = ed.z, by = ed.w;
      const bool straddle = (ay > py) != (by > py);
      const float denom = (by == ay) ? 1.0f : __fsub_rn(by, ay);
      // multiply, then divide: the evaluation order of sql/join.py _ray_parity
      const float xc = __fadd_rn(
          ax, __fdiv_rn(__fmul_rn(__fsub_rn(py, ay), __fsub_rn(bx, ax)), denom));
      if (straddle && px < xc) par ^= b;
      if (banded) {
        const float ex = __fsub_rn(bx, ax), ey = __fsub_rn(by, ay);
        const float qx = __fsub_rn(px, ax), qy = __fsub_rn(py, ay);
        const float dd = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
        float tt = __fdiv_rn(__fadd_rn(__fmul_rn(qx, ex), __fmul_rn(qy, ey)),
                             dd == 0.0f ? 1.0f : dd);
        tt = fminf(fmaxf(tt, 0.0f), 1.0f);
        const float rx = __fsub_rn(qx, __fmul_rn(tt, ex));
        const float ry = __fsub_rn(qy, __fmul_rn(tt, ey));
        if (__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)) <= eps2 && b != 0u)
          near = 1;
      }
    }
    const int* gr = geom + row * M2;
    for (int m = 0; m < M2; ++m) {
      const int gm = gr[m];
      if (((par >> m) & 1u) && gm >= 0 && gm < best) best = gm;
    }
  }
  best_out[k] = best;
  if (banded) near_out[k] = (unsigned char)near;
}

}  // namespace

extern "C" int mosaic_pip_zone(const float* points, long long n,
                               const float* planes, int E, int G, int n_real_g,
                               int* out, void* stream) {
  const long long blocks = (n + kZoneThreads - 1) / kZoneThreads;
  pip_zone_kernel<<<(unsigned int)blocks, kZoneThreads, 0,
                    (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(points), n, planes, E, G, n_real_g, out);
  return (int)cudaGetLastError();
}

extern "C" int mosaic_pip_heavy(const float* px, const float* py,
                                const int* rows, long long K,
                                const float* edges, const unsigned int* bits,
                                const int* geom, int E2, int M2, float eps2,
                                int banded, int* best, unsigned char* near,
                                void* stream) {
  const long long blocks = (K + kHeavyThreads - 1) / kHeavyThreads;
  pip_heavy_kernel<<<(unsigned int)blocks, kHeavyThreads, 0,
                     (cudaStream_t)stream>>>(
      px, py, rows, K, reinterpret_cast<const float4*>(edges), bits, geom, E2,
      M2, eps2, banded, best, near);
  return (int)cudaGetLastError();
}
