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
//   edge. Rows are int32 and slot bits uint32, as in the reference kernel.
//   Design: the points are grouped by heavy row on the device, a counting
//   sort in three small kernels — pip_heavy_hist_kernel counts each row's
//   points (warp-aggregated integer atomics) and keeps each point's rank
//   in its row, pip_heavy_scan_kernel scans the counts in one block, and
//   pip_heavy_scatter_kernel writes the points (index, x, y) in row order
//   and cuts every row into work items of at most kHeavyGroup (32)
//   points. One block of pip_heavy_kernel takes one work item: a bulk (TMA)
//   copy on an mbarrier stages the row's edges in shared memory (a row
//   wider than kHeavyChunkE edges in chunks, a phase each) while the
//   threads load its slot bits and geoms; each of its four warps then
//   tests the item's points, one a lane, against every fourth edge, the
//   whole warp reading one edge at a time as a shared-memory broadcast,
//   and the four partial parities are XORed (the band flags ORed). A row
//   no point touches makes no work item; a crowded row spreads over many
//   blocks, and a tile's few hundred points a row still fill several
//   warps an SM. The grid is the bound ceil(K/32) + min(H, K) on the
//   items, known without reading the count back; the blocks past the
//   count leave at once (a grid of resident blocks striding over the items
//   was slower on the join, PERF.md). Rows past the table (>= H) are pads,
//   as the reference kernel masks them. Pad edges (slot bits 0) are
//   skipped, the crossing is divided only where the ray straddles the
//   edge, and the band's projection only where its clamp is not already
//   decided (the argument is beside the code).
//   Bound on this card: the work the inputs need is a straddle test per
//   (point, real edge), a crossing per straddling pair and, with the
//   band, its distance per real edge; at the join's 228,851 heavy points
//   that is 8.55M tests and 2.40M crossings, 42M f32 operations (1.3 us),
//   and 5.5 MB of points and of the touched rows' slot bits, real edges
//   and geoms (1.6 us): bytes bound it. What
//   holds it instead, read from the code and its SASS rather than from
//   hardware counters, is instruction issue in the probe — a warp runs the
//   correctly rounded division of the crossing (about a dozen
//   instructions with its range check) whenever one of its lanes
//   straddles the edge, which is nearly every edge, as 28% of the pairs
//   straddle — and, in the sort, the 229k integer atomics on the 2,133
//   row counters and the scatter's random stores. A tile's launch (a few
//   thousand live points in a handful of rows) is bound by the latency of
//   the five dependent device ops. Times: PERF.md, kernel table.
//   What the old design lost: one thread per point, in the points' input
//   order, walked its own row straight from global memory, so the 32
//   lanes of a warp read 32 different rows, 32 sectors for the edge and
//   32 for the slot bits at every edge step: an estimated ~0.7 GB of L2
//   traffic for the 2.2 MB of tables at the join's points, 0.13 ms. The
//   traffic is an estimate from the access pattern, not a counter reading;
//   the probe kernel below does the same tests in 0.020 ms reading each
//   row once per 32 points.
//
// Floating point: every operation is written with the round-to-nearest
// intrinsics (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), which nvcc never
// contracts into FMAs, and the library builds with -fmad=false as well, so
// each kernel is bit-identical to its plain torch version. pip_zone divides
// once per edge (slope) and pip_heavy multiplies then divides — the two
// reference kernels round differently and each port keeps its own order.
//
// Each C entry point launches on the given stream, allocates nothing (the
// caller passes any scratch) and returns the first CUDA error.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kZoneTileE = 64;   // edges per shared-memory stage
constexpr int kZoneTileG = 32;   // polygons per shared-memory stage
constexpr int kZoneThreads = 256;
constexpr int kHeavyGroup = 32;     // points a work item holds: one a lane
constexpr int kHeavySlices = 4;     // warps a work item's block splits the edges over
constexpr int kHeavyThreads = kHeavyGroup * kHeavySlices;
constexpr int kHeavyChunkE = 512;   // edges staged per pass: 8 KB + 2 KB of bits
constexpr int kSortThreads = 256;
constexpr int kScanThreads = 1024;  // 32 warps: one warp scans the warp totals
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

// --- pip_heavy: a counting sort of the points by heavy row, then one block
// per work item (row, first sorted position, point count)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Counts each row's points, keeps each point's rank within its row, and
// writes the outputs of pad points (row -1, or a row past the table, which
// the reference kernel masks the same way), which enter no bucket. Lanes of
// one warp that share a row take one atomic between them.
__global__ void __launch_bounds__(kSortThreads)
pip_heavy_hist_kernel(const int* __restrict__ rows, long long K, int H,
                      int* __restrict__ cnt, int* __restrict__ rank,
                      int banded, int* __restrict__ best_out,
                      unsigned char* __restrict__ near_out) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int rk = k < K ? rows[k] : -1;
  const int r = rk < H ? rk : -1;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned grp = __match_any_sync(0xffffffffu, r);
  const int leader = __ffs(grp) - 1;
  int base = 0;
  if (r >= 0 && (int)lane == leader) base = atomicAdd(&cnt[r], __popc(grp));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (k >= K) return;
  if (r >= 0) {
    rank[k] = base + __popc(grp & ((1u << lane) - 1u));
  } else {
    best_out[k] = INT_MAX;
    if (banded) near_out[k] = 0;
  }
}

// One block: exclusive scans of the row counts (each row's first sorted
// position) and of the rows' work-item counts (each row's first item), and
// the number of items.
__global__ void __launch_bounds__(kScanThreads)
pip_heavy_scan_kernel(const int* __restrict__ cnt, int H, int* __restrict__ off,
                      int* __restrict__ item_off, int* __restrict__ n_items) {
  __shared__ int warp_pts[32], warp_items[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (H + kScanThreads - 1) / kScanThreads;
  const int r0 = min(t * per, H), r1 = min(r0 + per, H);
  int pts = 0, its = 0;
  for (int r = r0; r < r1; ++r) {
    const int c = cnt[r];
    pts += c;
    its += (c + kHeavyGroup - 1) / kHeavyGroup;
  }
  int ip = pts, ii = its;  // inclusive scans within the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, ip, d);
    const int b = __shfl_up_sync(0xffffffffu, ii, d);
    if (lane >= d) {
      ip += a;
      ii += b;
    }
  }
  if (lane == 31) {
    warp_pts[warp] = ip;
    warp_items[warp] = ii;
  }
  __syncthreads();
  if (warp == 0) {
    const int wp = warp_pts[lane], wi = warp_items[lane];
    int sp = wp, si = wi;
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, sp, d);
      const int b = __shfl_up_sync(0xffffffffu, si, d);
      if (lane >= d) {
        sp += a;
        si += b;
      }
    }
    warp_pts[lane] = sp - wp;  // exclusive
    warp_items[lane] = si - wi;
  }
  __syncthreads();
  int run_p = warp_pts[warp] + ip - pts;
  int run_i = warp_items[warp] + ii - its;
  for (int r = r0; r < r1; ++r) {
    const int c = cnt[r];
    off[r] = run_p;
    item_off[r] = run_i;
    run_p += c;
    run_i += (c + kHeavyGroup - 1) / kHeavyGroup;
  }
  if (t == kScanThreads - 1) *n_items = run_i;
}

// perm[off[row] + rank] = point, and the point's coordinates beside it: the
// points in row order. The first point of each work item writes the item,
// {row, first sorted position, points, 0}.
__global__ void __launch_bounds__(kSortThreads)
pip_heavy_scatter_kernel(const float* __restrict__ px, const float* __restrict__ py,
                         const int* __restrict__ rows, long long K, int H,
                         const int* __restrict__ cnt, const int* __restrict__ off,
                         const int* __restrict__ item_off,
                         const int* __restrict__ rank, int* __restrict__ perm,
                         float2* __restrict__ sorted_xy, int4* __restrict__ items) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int r = rows[k];
  if (r < 0 || r >= H) return;
  const int rk = rank[k], pos = off[r] + rk;
  perm[pos] = (int)k;
  sorted_xy[pos] = make_float2(px[k], py[k]);
  if (rk % kHeavyGroup == 0)
    items[item_off[r] + rk / kHeavyGroup] =
        make_int4(r, pos, min(kHeavyGroup, cnt[r] - rk), 0);
}

// Every thread's reads of the shared arrays are done and ordered before the
// next bulk copy writes s_edge: the reads are generic-proxy accesses, the
// copy writes through the async proxy, and the PTX memory model orders the
// two proxies only across a proxy fence.
__device__ __forceinline__ void release_stage() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// One block per work item: warp w of the kHeavySlices warps tests the
// item's points (one a lane) against the edges e = w, w + kHeavySlices, ...
// of the staged row, and the slices' parities are XORed and their band
// flags ORed at the end: a short run of points still keeps several warps
// busy, and pad edges, which sit at the end of a row, spread evenly. A row
// wider than kHeavyChunkE edges is staged in chunks, a phase of the
// mbarrier each.
__global__ void __launch_bounds__(kHeavyThreads)
pip_heavy_kernel(const float2* __restrict__ sorted_xy,
                 const int* __restrict__ perm, const int4* __restrict__ items,
                 const int* __restrict__ n_items,
                 const float4* __restrict__ edges,
                 const unsigned int* __restrict__ bits,
                 const int* __restrict__ geom, int E2, int M2, float eps2,
                 int banded, int* __restrict__ best_out,
                 unsigned char* __restrict__ near_out) {
  __shared__ __align__(128) float4 s_edge[kHeavyChunkE];
  __shared__ unsigned int s_bits[kHeavyChunkE];
  __shared__ int s_geom[32];
  __shared__ unsigned int s_par[kHeavySlices][kHeavyGroup];
  __shared__ int s_near[kHeavySlices][kHeavyGroup];
  __shared__ __align__(8) unsigned long long s_bar;
  // the grid is an upper bound on the work items: the rest leave at once
  if ((int)blockIdx.x >= *n_items) return;
  const int4 item = items[blockIdx.x];
  const long long row = item.x;  // widened: row * E2 may pass 2^31
  const int t = threadIdx.x, lane = t % kHeavyGroup, slice = t / kHeavyGroup;
  const bool live = lane < item.z;
  float px = 0.0f, py = 0.0f;
  if (live) {
    const float2 p = sorted_xy[item.y + lane];
    px = p.x;
    py = p.y;
  }
  const unsigned bar = smem_addr(&s_bar);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (t < M2) s_geom[t] = geom[row * M2 + t];
  __syncthreads();
  const float4* er = edges + row * E2;
  const unsigned int* br = bits + row * E2;
  unsigned int par = 0u, phase = 0u;
  int near = 0;
  for (int e0 = 0; e0 < E2; e0 += kHeavyChunkE) {
    const int n = min(kHeavyChunkE, E2 - e0);
    if (e0 > 0) release_stage();  // the previous chunk is fully read
    if (t == 0) {
      const unsigned bytes = (unsigned)n * 16u;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          ::"r"(smem_addr(s_edge)), "l"(er + e0), "r"(bytes), "r"(bar)
          : "memory");
    }
    for (int e = t; e < n; e += kHeavyThreads) s_bits[e] = br[e0 + e];
    unsigned done = 0u;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(phase) : "memory");
    }
    phase ^= 1u;
    __syncthreads();  // the slot bits are in place
    if (!live) continue;
    for (int e = slice; e < n; e += kHeavySlices) {
      const unsigned int b = s_bits[e];
      if (b == 0u) continue;  // a pad edge: changes neither parity nor near
      const float4 ed = s_edge[e];
      const float ax = ed.x, ay = ed.y, bx = ed.z, by = ed.w;
      if ((ay > py) != (by > py)) {
        // a straddled edge has by != ay, so the reference's denominator
        // (by == ay ? 1 : by - ay) is by - ay; multiply, then divide: the
        // evaluation order of sql/join.py _ray_parity
        const float xc = __fadd_rn(
            ax, __fdiv_rn(__fmul_rn(__fsub_rn(py, ay), __fsub_rn(bx, ax)),
                          __fsub_rn(by, ay)));
        if (px < xc) par ^= b;
      }
      if (banded && !near) {
        const float ex = __fsub_rn(bx, ax), ey = __fsub_rn(by, ay);
        const float qx = __fsub_rn(px, ax), qy = __fsub_rn(py, ay);
        const float dd = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
        const float dot = __fadd_rn(__fmul_rn(qx, ex), __fmul_rn(qy, ey));
        // t = clamp(dot / (dd == 0 ? 1 : dd), 0, 1), dividing only where
        // the clamp is not decided already. dd >= 0 (or NaN, and then dot
        // is NaN too). dot <= 0: the quotient is <= 0, -0, or NaN (dot =
        // -inf, dd = inf), each of which clamps to 0 (fmaxf drops a NaN);
        // t = -0 against +0 cannot change rx*rx + ry*ry. 0 < dd < inf and
        // dot >= dd: the exact quotient is >= 1 and so is its correctly
        // rounded value, which clamps to 1. dd == 0 with dot > 0 (ex*ex
        // and ey*ey underflowed) and dd == inf divide: dot / 1 may lie
        // inside (0, 1), and inf / inf is NaN, which clamps to 0.
        float tt;
        if (dot <= 0.0f) {
          tt = 0.0f;
        } else if (dd > 0.0f && dd < INFINITY && dot >= dd) {
          tt = 1.0f;
        } else {
          tt = fminf(fmaxf(__fdiv_rn(dot, dd == 0.0f ? 1.0f : dd), 0.0f), 1.0f);
        }
        const float rx = __fsub_rn(qx, __fmul_rn(tt, ex));
        const float ry = __fsub_rn(qy, __fmul_rn(tt, ey));
        if (__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)) <= eps2) near = 1;
      }
    }
  }
  s_par[slice][lane] = par;
  s_near[slice][lane] = near;
  __syncthreads();
  if (slice != 0 || !live) return;
  for (int w = 1; w < kHeavySlices; ++w) {
    par ^= s_par[w][lane];
    near |= s_near[w][lane];
  }
  // best = the smallest geom >= 0 over the slots < M2 with odd parity
  const unsigned int slots = M2 >= 32 ? 0xffffffffu : ((1u << M2) - 1u);
  int best = INT_MAX;
  for (unsigned int p = par & slots; p; p &= p - 1u) {
    const int gm = s_geom[__ffs(p) - 1];
    if (gm >= 0 && gm < best) best = gm;
  }
  const int k = perm[item.y + lane];
  best_out[k] = best;
  if (banded) near_out[k] = (unsigned char)near;
}

long long heavy_max_items(long long K, int H) {
  return (K + kHeavyGroup - 1) / kHeavyGroup + (H < K ? H : K);
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

// int32 scratch that mosaic_pip_heavy needs for K points and H rows: the
// work items (4 each, first, for their 16-byte alignment), the sorted
// coordinates (2 each), perm and rank (K each), the rows' first positions,
// first items and counts (H each) and the number of items.
extern "C" long long mosaic_pip_heavy_scratch(long long K, int H) {
  return 4 * heavy_max_items(K, H) + 4 * K + 3 * (long long)H + 1;
}

// Groups the K points by row and probes each group against its staged row:
// a memset and four kernels on `stream`. `edges` and `scratch` must be
// 16-byte aligned, K < 2^31, M2 <= 32.
extern "C" int mosaic_pip_heavy(const float* px, const float* py,
                                const int* rows, long long K, int H,
                                const float* edges, const unsigned int* bits,
                                const int* geom, int E2, int M2, float eps2,
                                int banded, int* best, unsigned char* near,
                                int* scratch, long long scratch_ints,
                                void* stream) {
  if (K <= 0 || H <= 0) return (int)cudaSuccess;
  if (K >= INT_MAX || M2 > 32 || scratch_ints < mosaic_pip_heavy_scratch(K, H) ||
      (reinterpret_cast<uintptr_t>(edges) & 15u) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15u))
    return (int)cudaErrorInvalidValue;
  const long long max_items = heavy_max_items(K, H);
  int4* items = reinterpret_cast<int4*>(scratch);
  float2* sorted_xy = reinterpret_cast<float2*>(scratch + 4 * max_items);
  int* perm = scratch + 4 * max_items + 2 * K;
  int* rank = perm + K;
  int* off = rank + K;
  int* item_off = off + H;
  int* cnt = item_off + H;
  int* n_items = cnt + H;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(cnt, 0, (size_t)H * sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned int sort_blocks = (unsigned int)((K + kSortThreads - 1) / kSortThreads);
  pip_heavy_hist_kernel<<<sort_blocks, kSortThreads, 0, s>>>(
      rows, K, H, cnt, rank, banded, best, near);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  pip_heavy_scan_kernel<<<1, kScanThreads, 0, s>>>(cnt, H, off, item_off, n_items);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  pip_heavy_scatter_kernel<<<sort_blocks, kSortThreads, 0, s>>>(
      px, py, rows, K, H, cnt, off, item_off, rank, perm, sorted_xy, items);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  pip_heavy_kernel<<<(unsigned int)max_items, kHeavyThreads, 0, s>>>(
      sorted_xy, perm, items, n_items, reinterpret_cast<const float4*>(edges),
      bits, geom, E2, M2, eps2, banded, best, near);
  return (int)cudaGetLastError();
}
