// H3 cell assignment for Hopper (sm_90a), bound to Python by ctypes.
//
// h3_cells_kernel — replaces no Pallas kernel: the JAX package runs
//   mosaic_tpu/core/index/h3/core.py geo_to_cell as one jitted program,
//   which XLA fuses on the TPU. The port ran the same chain as ~600 eager
//   torch ops (core/index/h3/core.py _geo_to_cell_device), each one
//   reading and writing whole per-point intermediates in device memory.
//   This kernel maps (N, 2) lng/lat degrees to (N,) int64 H3 cells at one
//   resolution, and for the margin variant to the (N, 2) relative margins
//   of the finest rounding (core._rel_margin), one thread a point end to
//   end: deg2rad, geo_to_vec3, the nearest face (the first of the 20
//   largest dots, a NaN dot the largest, as torch.argmax), the gnomonic
//   projection on the face basis, the class-III rotation, the hex
//   rounding of hexmath.hex2d_to_axial, then `res` levels of int32
//   aperture-7 up and down steps, each digit going into a packed word in
//   registers as it is produced and the lead digit tracked on the way;
//   last the (face, ijk) combo lookup (core._combo_table), the row's turns
//   (core._TURNS), the digit rotation (hexmath.ROT60_CCW_POW) and the bit
//   layout of hexmath.pack_packed.
//   Bound on this card: a point reads 8 or 16 bytes and writes 8 (24 or 48
//   with margins) — about 0.005 ms a million f32 points at 3.35 TB/s — and
//   runs on the order of a thousand instructions (four transcendentals, 20
//   face dots, a projection with three divisions, the digit levels): about
//   0.03 ms a million points at the card's 33.5e12 ops/s. Instruction
//   issue bounds it.
//   Design: the constant tables (face centres and face bases in the input
//   dtype, the combo, turns and rotation tables in int32; under 6 KB) are
//   staged in shared memory once a block, since face-indexed loads differ
//   across a warp; a grid-stride loop of 256-thread blocks, a few resident
//   blocks an SM, walks the points; the input is read through its strides
//   (a ring slot's view or a column-major array needs no copy); nothing is
//   written to device memory but the outputs; no atomics, no reductions.
//
// Floating point: the kernel repeats the plain version op for op as ATen
// evaluates it on the card, so cells and margins are its bits. Every
// operation is a round-to-nearest intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn and their double forms), never contracted into a multiply-add,
// and the library builds with -fmad=false as well; sinf/cosf (sin/cos in
// float64) are the functions ATen's unary kernels call; round is rintf
// (half to even), as torch.round; a Python float operand is rounded to the
// tensor's dtype first, as ATen does with a CPU scalar; the one division by
// a Python float (y / SIN60 in hex2d_to_axial) is a product with the
// reciprocal, which the wrapper computes in the dtype: ATen's CUDA division
// by a CPU scalar multiplies by its reciprocal. clamp and maximum keep a
// NaN as ATen's do. Integer steps wrap as torch's int64 and int32 tensors
// do (unsigned arithmetic here), so NaN and infinite rows give the plain
// version's cells too.
//
// The C entry point launches on the given stream, allocates nothing and
// returns the first CUDA error.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kFaces = 20;
constexpr int kCombo = kFaces * 27;  // (face, i*9 + j*3 + k)
constexpr int kTurns = 256;          // (rot << 2 | cw << 1 | pent) * 8 + lead
constexpr int kPow = 6 * 8;          // turns * 8 + digit
constexpr int kMaxRes = 15;
constexpr int kBaseCellOffset = 45;
constexpr int kDigitBits = 3;

// the scalars the plain version multiplies, divides or clamps by, as
// Python floats; each is rounded to T where it is used
struct Scalars {
  double deg2rad;    // ATen's deg2rad factor, pi / 180
  double scale;      // SQRT7**res / RES0_U_GNOMONIC
  double cos_ap7;    // class-III rotation
  double sin_ap7;
  double sin60;
  double inv_sin60;  // 1 / SIN60 computed in T: the card's y / SIN60
  double dot_floor;  // 0.2: the floor of the face dot
  double s0;         // the margins' noise scale floor at res
  long long pad;     // mode, res and the INVALID digits past res
  int res;
};

template <typename T> struct Ops;

template <> struct Ops<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float cos(float a) { return cosf(a); }
  static __device__ __forceinline__ float sin(float a) { return sinf(a); }
  static __device__ __forceinline__ float rint(float a) { return rintf(a); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
};

template <> struct Ops<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double cos(double a) { return ::cos(a); }
  static __device__ __forceinline__ double sin(double a) { return ::sin(a); }
  static __device__ __forceinline__ double rint(double a) { return ::rint(a); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static __device__ __forceinline__ double min(double a, double b) { return fmin(a, b); }
};

// torch.maximum / torch.minimum: a NaN operand is the result
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : Ops<T>::max(a, b));
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : Ops<T>::min(a, b));
}
// torch.clamp(v, min=lo): a NaN stays
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v != v ? v : Ops<T>::max(v, lo);
}

// int32 arithmetic that wraps, as torch's int32 tensors do
__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul(int c, int a) { return (int)((unsigned)c * (unsigned)a); }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// torch's floor division of an int32 by 14 (c10::div_floor_integer)
__device__ __forceinline__ int floor_div14(int n) {
  const int q = n / 14;
  return (n % 14 != 0 && n < 0) ? q - 1 : q;
}

// hexmath._round_div7: (2n + 7) // 14
__device__ __forceinline__ int round_div7(int n) {
  return floor_div14(wadd(wmul(2, n), 7));
}

// hexmath.ijk_normalize
__device__ __forceinline__ void normalize(int& i, int& j, int& k) {
  const int m = imin(imin(i, j), k);
  i = wsub(i, m);
  j = wsub(j, m);
  k = wsub(k, m);
}

template <typename T, bool kMargin>
__global__ void __launch_bounds__(kThreads)
h3_cells_kernel(const T* __restrict__ xy, long long n, long long s_row,
                long long s_col, const T* __restrict__ face_vec,
                const T* __restrict__ face_basis, const int* __restrict__ combo,
                const int* __restrict__ turns_tab, const int* __restrict__ pow_tab,
                Scalars sc, long long* __restrict__ cells, T* __restrict__ margin) {
  using O = Ops<T>;
  __shared__ T s_vec[kFaces * 3];
  __shared__ T s_basis[kFaces * 9];
  __shared__ int s_combo[kCombo];
  __shared__ int s_turns[kTurns];
  __shared__ int s_pow[kPow];
  for (int t = threadIdx.x; t < kFaces * 9; t += blockDim.x) {
    s_basis[t] = face_basis[t];
    if (t < kFaces * 3) s_vec[t] = face_vec[t];
  }
  for (int t = threadIdx.x; t < kCombo; t += blockDim.x) {
    s_combo[t] = combo[t];
    if (t < kTurns) s_turns[t] = turns_tab[t];
    if (t < kPow) s_pow[t] = pow_tab[t];
  }
  __syncthreads();

  const T deg2rad = (T)sc.deg2rad, scale = (T)sc.scale;
  const T cos_ap7 = (T)sc.cos_ap7, sin_ap7 = (T)sc.sin_ap7;
  const T sin60 = (T)sc.sin60, inv_sin60 = (T)sc.inv_sin60;
  const T dot_floor = (T)sc.dot_floor, s0 = (T)sc.s0;
  const T half = (T)0.5;
  const int res = sc.res;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < n; p += stride) {
    // _geo: deg2rad of each column; hexmath.geo_to_vec3
    const T lng = O::mul(xy[p * s_row], deg2rad);
    const T lat = O::mul(xy[p * s_row + s_col], deg2rad);
    const T cl = O::cos(lat);
    const T v0 = O::mul(cl, O::cos(lng));
    const T v1 = O::mul(cl, O::sin(lng));
    const T v2 = O::sin(lat);

    // hexmath.nearest_face: the first largest dot, a NaN dot the largest
    int face = 0;
    T best = 0;
    for (int f = 0; f < kFaces; ++f) {
      const T* c = s_vec + 3 * f;
      const T d = O::add(O::add(O::mul(v0, c[0]), O::mul(v1, c[1])), O::mul(v2, c[2]));
      if (f == 0 || (d != d && best == best) || d > best) {
        best = d;
        face = f;
      }
    }

    // hexmath.geo_to_hex2d on the face's tangent basis
    const T* b = s_basis + 9 * face;
    const T dot = O::add(O::add(O::mul(v0, b[0]), O::mul(v1, b[1])), O::mul(v2, b[2]));
    const T dm = clamp_min(dot, dot_floor);
    const T p0 = O::sub(O::div(v0, dm), b[0]);
    const T p1 = O::sub(O::div(v1, dm), b[1]);
    const T p2 = O::sub(O::div(v2, dm), b[2]);
    const T gx = O::add(O::add(O::mul(p0, b[3]), O::mul(p1, b[4])), O::mul(p2, b[5]));
    const T gy = O::add(O::add(O::mul(p0, b[6]), O::mul(p1, b[7])), O::mul(p2, b[8]));
    T x = O::mul(gx, scale);
    T y = O::mul(gy, scale);
    if (res & 1) {
      const T xr = O::add(O::mul(x, cos_ap7), O::mul(y, sin_ap7));
      y = O::sub(O::mul(y, cos_ap7), O::mul(x, sin_ap7));
      x = xr;
    }

    // hexmath.hex2d_to_axial: cube rounding in the (ii, -jj, jj - ii) basis
    const T jj = O::mul(y, inv_sin60);
    const T ii = O::add(x, O::mul(half, jj));
    const T q = ii, r = -jj, s = O::sub(jj, ii);
    T rq = O::rint(q), rr = O::rint(r);
    const T rs = O::rint(s);
    const T dq = O::abs(O::sub(rq, q));
    const T dr = O::abs(O::sub(rr, r));
    const T ds = O::abs(O::sub(rs, s));
    const bool fix_q = (dq > dr) && (dq > ds);
    const bool fix_r = !fix_q && (dr > ds);
    if (fix_q) rq = O::sub(-rr, rs);
    if (fix_r) rr = O::sub(-rq, rs);
    const long long ai = (long long)rq;
    const long long aj = (long long)(-rr);

    if (kMargin) {
      // core._rel_margin over hexmath.hex_round_margins
      const T iif = (T)ai, jjf = (T)aj;
      const T dx = O::sub(x, O::sub(iif, O::mul(half, jjf)));
      const T dy = O::sub(y, O::mul(jjf, sin60));
      const T sdy = O::mul(sin60, dy);
      const T a1 = O::abs(dx);
      const T a2 = O::abs(O::add(O::mul(half, dx), sdy));
      const T a3 = O::abs(O::add(O::mul(-half, dx), sdy));
      const T hi = nan_max(a1, nan_max(a2, a3));
      const T lo = nan_min(a1, nan_min(a2, a3));
      const T mid = O::sub(O::sub(O::add(O::add(a1, a2), a3), hi), lo);
      const T m1 = O::sub(half, hi);
      const T m2 = O::sub(half, mid);
      const T sm = clamp_min(nan_max(O::abs(x), O::abs(y)), s0);
      margin[2 * p] = O::div(m1, sm);
      margin[2 * p + 1] = O::div(m2, sm);
    }

    // ijk_normalize in int64, then the int32 digit math of the device path
    const unsigned long long m =
        (unsigned long long)(ai < aj ? (ai < 0 ? ai : 0) : (aj < 0 ? aj : 0));
    int i = (int)((unsigned long long)ai - m);
    int j = (int)((unsigned long long)aj - m);
    int k = (int)(0ull - m);

    unsigned long long raw = 0;  // digit of level lv at bit (15 - lv) * 3
    int lead = 0;
    for (int lv = res; lv > 0; --lv) {
      const int li = i, lj = j, lk = k;
      const int ii2 = wsub(i, k), jj2 = wsub(j, k);
      int ci, cj, ck;
      if (lv & 1) {  // class III: up_ap7, then down_ap7
        i = round_div7(wsub(wmul(3, ii2), jj2));
        j = round_div7(wadd(ii2, wmul(2, jj2)));
        k = 0;
        normalize(i, j, k);
        ci = wadd(wadd(wmul(3, i), j), wmul(0, k));
        cj = wadd(wadd(wmul(0, i), wmul(3, j)), k);
        ck = wadd(wadd(i, wmul(0, j)), wmul(3, k));
      } else {  // class II: up_ap7r, then down_ap7r
        i = round_div7(wadd(wmul(2, ii2), jj2));
        j = round_div7(wsub(wmul(3, jj2), ii2));
        k = 0;
        normalize(i, j, k);
        ci = wadd(wadd(wmul(3, i), wmul(0, j)), k);
        cj = wadd(wadd(i, wmul(3, j)), wmul(0, k));
        ck = wadd(wadd(wmul(0, i), j), wmul(3, k));
      }
      normalize(ci, cj, ck);
      int di = wsub(li, ci), dj = wsub(lj, cj), dk = wsub(lk, ck);
      normalize(di, dj, dk);
      // hexmath.unit_ijk_to_digit_i32
      const bool valid = (((di | dj | dk) >> 1) == 0) && !((di & dj & dk) == 1);
      const int d = valid ? wadd(wadd(wmul(4, di), wmul(2, dj)), dk) : 7;
      raw |= (unsigned long long)d << ((kMaxRes - lv) * kDigitBits);
      if (d != 0) lead = d;
    }

    i = i < 0 ? 0 : (i > 2 ? 2 : i);
    j = j < 0 ? 0 : (j > 2 ? 2 : j);
    k = k < 0 ? 0 : (k > 2 ? 2 : k);
    const int cb = s_combo[face * 27 + i * 9 + j * 3 + k];
    const int bc = (cb >> 5) - 1;
    unsigned long long h =
        ((unsigned long long)(long long)bc << kBaseCellOffset) | (unsigned long long)sc.pad;
    if (res > 0) {
      const int* rot = s_pow + 8 * s_turns[(cb & 31) * 8 + lead];
      for (int lv = 1; lv <= res; ++lv) {
        const int shift = (kMaxRes - lv) * kDigitBits;
        h |= (unsigned long long)rot[(raw >> shift) & 7] << shift;
      }
    }
    cells[p] = (long long)h;
  }
}

template <typename T>
int launch(const T* xy, long long n, long long s_row, long long s_col,
           const T* face_vec, const T* face_basis, const int* combo,
           const int* turns, const int* pow_tab, const double* scalars,
           long long pad, int res, long long* cells, T* margin, void* stream) {
  if (n <= 0) return 0;
  const Scalars sc{scalars[0], scalars[1], scalars[2], scalars[3], scalars[4],
                   scalars[5], scalars[6], scalars[7], pad, res};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  const unsigned int blocks = (unsigned int)(want < cap ? want : cap);
  cudaStream_t st = (cudaStream_t)stream;
  if (margin != nullptr) {
    h3_cells_kernel<T, true><<<blocks, kThreads, 0, st>>>(
        xy, n, s_row, s_col, face_vec, face_basis, combo, turns, pow_tab, sc, cells, margin);
  } else {
    h3_cells_kernel<T, false><<<blocks, kThreads, 0, st>>>(
        xy, n, s_row, s_col, face_vec, face_basis, combo, turns, pow_tab, sc, cells, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xy: (n, 2) lng/lat degrees read at xy[p * s_row + c * s_col]; face_vec
// (20, 3) and face_basis (20, 9) in the input dtype; combo (20 * 27),
// turns (256) and pow_tab (48) int32; scalars: the 8 doubles of Scalars in
// order; cells (n,) int64; margin (n, 2) contiguous, or null for cells alone
extern "C" int mosaic_h3_cells_f32(const float* xy, long long n, long long s_row,
                                   long long s_col, const float* face_vec,
                                   const float* face_basis, const int* combo,
                                   const int* turns, const int* pow_tab,
                                   const double* scalars, long long pad, int res,
                                   long long* cells, float* margin, void* stream) {
  return launch<float>(xy, n, s_row, s_col, face_vec, face_basis, combo, turns,
                       pow_tab, scalars, pad, res, cells, margin, stream);
}

extern "C" int mosaic_h3_cells_f64(const double* xy, long long n, long long s_row,
                                   long long s_col, const double* face_vec,
                                   const double* face_basis, const int* combo,
                                   const int* turns, const int* pow_tab,
                                   const double* scalars, long long pad, int res,
                                   long long* cells, double* margin, void* stream) {
  return launch<double>(xy, n, s_row, s_col, face_vec, face_basis, combo, turns,
                        pow_tab, scalars, pad, res, cells, margin, stream);
}
