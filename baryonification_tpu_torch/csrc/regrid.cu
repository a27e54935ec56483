// The shell regrid for Hopper (sm_90a): every input pixel's unit vector,
// moved by its offset, redeposits the pixel's mass into the four HEALPix
// RING pixels around the moved direction with bilinear weights.
//
// Replaces no TPU kernel: in the JAX package this step is XLA code,
// _regrid_shell (baryonification_tpu/runners/shell.py:756) on the closed-
// form weights of ops/healpix.py get_interp_weights_parts (:447), z_to_ring
// (:201) and ring_info (:167), ending in one scatter of 4 x npix rows. The
// port's plain version (ops/regrid_cuda.py regrid_shell_reference) is the
// same chain of elementwise PyTorch ops, four concatenated id and mass
// planes and one index_add_.
//
// Design. What bounds it, measured on an H100 at the inputs of one
// shell-1e6 process() (12.6M NESTED pixels, float32;
// experiments/regrid/split.py and chip_smoke.py, PERF.md): a first
// design that computed every ring term for every pixel in 64-bit
// integers and made four red.global.add a pixel took 0.40 ms, its corners
// alone 0.32 ms (668 SASS instructions a pixel, an issue bound of
// 0.25 ms), its adds alone 0.39 ms (5.0e7 adds into 1.26e7
// destinations), the map's memset 0.018 ms; the bytes (0.12 ms) did not
// bound it. So:
//
// 1. regrid_rings fills a table of the 4 nside rings once per (NSIDE,
//    dtype, device): each ring's first pixel and length (int32), its
//    theta, phi step and shift, and the step's reciprocal. A pixel reads
//    its two rings' rows (32 or 48 bytes each, through the read-only
//    path) in place of two acos, six IEEE divisions and the rings'
//    integer arithmetic.
// 2. Rings, floors, remainders and ids are 32-bit: npix < 2^30 up to
//    MAX_NSIDE = 8192. A column's remainder takes compares; the division
//    runs only past them.
// 3. A warp merges its 128 rows by destination before the global adds
//    (merge_rows: four rounds of __match_any_sync, one a (ring parity,
//    id parity), so all the rows of one destination meet in one round),
//    which leaves one add a (warp, destination): 0.39 of the rows. No
//    float atomic touches shared memory (sm_90a makes those a CAS loop).
// The corners now take 416 instructions a pixel and the kernel with its
// merge 591: it runs at about 85% of that issue bound, beside the merged
// adds (1.96e7 of them take 0.14 ms alone). regrid_vjp reads the same
// table (537 instructions, about 85% of its issue bound); its derivative
// in phi is a product with the table's reciprocal of the phi step, within
// a rounding of the plain version's division.
//
// Every operation that gives an id or a weight rounds as the plain
// version's PyTorch op on the card does, so the ids and weights are the
// plain ops' bit for bit: the file is built with --fmad=false, the Python
// scalars are taken in the hot dtype T, a division by a Python scalar is
// a product with its reciprocal (PyTorch's CUDA division by a CPU
// scalar), 2 pi / npr is reciprocal(npr) * 2 pi (Tensor.__rtruediv__),
// floor, the integer casts and remainders are those of PyTorch's kernels,
// and acos, atan2, cos and sqrt are the CUDA math library's, as in
// PyTorch's kernels. The table's entries are the same ops on the ring
// index, so they too are the plain ops' closed form of every ring bit for
// bit. regrid_parts writes each pixel's four ids and weights instead of
// adding them, so the tests and chip_smoke.py can hold them to the plain
// ops bit for bit.
//
// Deterministic route (what the wrapper takes under
// torch.use_deterministic_algorithms): regrid_count adds each (pixel,
// corner) with a nonzero value to its destination's count with integer
// atomics (exact); the wrapper scans the counts (torch.cumsum) into
// segment starts; regrid_fill recomputes the corners and places each
// key 4 i + k and its value in its destination's segment (in no fixed
// order within it); regrid_sum sorts each segment by key and sums it in
// key order, so the map is the same bit for bit from run to run. A
// segment of up to 16 rows is sorted in registers by its thread; a
// longer one (where mass converges) is listed and taken by a warp, which
// sorts it in shared memory (up to kWarpCap rows, else in place in
// global memory) with an all-ascending bitonic network and sums it in
// one lane. A zero value adds nothing to a map that starts at +0, so
// neither route adds one.
//
// The adjoint, regrid_vjp: one thread a pixel recomputes its corners,
// gathers the cotangent g_k = ct[p_k] at its four ids and writes its
// gradients once (no atomics): dL/dm = sum w_k g_k, and through the
// weights' derivatives in theta (inside wt's clamp, not at a pole) and
// phi, acos, the clamp of z / r, atan2 and the norm, dL/do = dL/d(x, y,
// z).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpCap = 256;            // rows a warp sorts in shared memory
constexpr int kLongWarps = 8;            // warps a CTA of regrid_long
constexpr int kRegisterRows = 16;        // longest segment a thread sorts
constexpr double kTwoPi = 6.283185307179586;

__device__ __forceinline__ float d_acos(float x) { return acosf(x); }
__device__ __forceinline__ double d_acos(double x) { return acos(x); }
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double d_atan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_floor(float x) { return floorf(x); }
__device__ __forceinline__ double d_floor(double x) { return floor(x); }

__device__ __forceinline__ float d_min(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double d_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float d_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double d_max(double a, double b) {
  return fmax(a, b);
}

// torch.clamp of a floating value: NaN passes, else min(max(v, lo), hi)
template <typename T>
__device__ __forceinline__ T clampf(T v, T lo, T hi) {
  return v != v ? v : d_min(d_max(v, lo), hi);
}
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v != v ? v : d_max(v, lo);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.remainder of a column a by a ring length b > 0 (the result in
// [0, b)): a is in [-1, b] for every direction but a NaN, so compares
// serve and the division runs only past them
__device__ __forceinline__ int remainder_i(int a, int b) {
  if (a >= 0 && a < b) return a;
  if (a < 0 && a >= -b) return a + b;
  if (a >= b && a - b < b) return a - b;
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// float(x) of a Python scalar, as PyTorch casts it to the op's dtype
template <typename T>
__device__ __forceinline__ T S(double x) {
  return static_cast<T>(x);
}

// ops/healpix.py z_to_ring; only the branch that z selects is computed
// (the plain version computes all three and selects, to the same bits)
template <typename T>
__device__ __forceinline__ int z_to_ring(int n, T z) {
  const T fn = static_cast<T>(n);
  int ring;
  if (z > S<T>(2.0 / 3.0)) {
    ring = static_cast<int>(d_floor(
        d_sqrt(clamp_min((S<T>(1.0) - z) * S<T>(3.0), T(0))) * fn));
  } else if (z < S<T>(-2.0 / 3.0)) {
    ring = 4 * n - 1 -
           static_cast<int>(d_floor(
               d_sqrt(clamp_min((z + S<T>(1.0)) * S<T>(3.0), T(0))) * fn));
  } else {
    ring = static_cast<int>(d_floor((S<T>(2.0) - z * S<T>(1.5)) * fn));
  }
  return clampi(ring, 0, 4 * n - 1);
}

// One row of the ring table: what ops/healpix.py ring_info and
// interp_terms' ring_neighbors compute from the ring index alone (its
// first pixel, its length, its theta, its phi step and shift, and the
// step's reciprocal, which only the adjoint reads)
template <typename T>
struct __align__(16) Ring {
  int start, npr;
  T theta, dphi, shift, inv_dphi;
};

// ring i of NSIDE n, op for op as the plain version: i ** 2 / (3 n n)
// and 2 i / (3 n) as products with the scalar's reciprocal, taken in T
template <typename T>
__device__ __forceinline__ Ring<T> ring_row(int n, int i) {
  const T inv3nn = T(1) / S<T>(3.0 * n * n);
  const T inv3n = T(1) / S<T>(3.0 * n);
  T zr, shift;
  int start, npr;
  if (i < n) {
    const T fi = static_cast<T>(i);
    zr = S<T>(1.0) - (fi * fi) * inv3nn;
    start = 2 * i * (i - 1);
    npr = 4 * i;
    shift = S<T>(0.5);
  } else if (i > 3 * n) {
    const int im = 4 * n - i;
    const T fm = static_cast<T>(im);
    zr = -(S<T>(1.0) - (fm * fm) * inv3nn);
    start = 12 * n * n - 2 * im * (im + 1);
    npr = 4 * im;
    shift = S<T>(0.5);
  } else {
    const T fi = static_cast<T>(i);
    zr = S<T>(4.0 / 3.0) - (fi * S<T>(2.0)) * inv3n;
    start = 2 * n * (n - 1) + 4 * n * (i - n);
    npr = 4 * n;
    shift = static_cast<T>((i - n + 1) & 1) * S<T>(0.5);
  }
  Ring<T> g;
  g.start = start;
  g.npr = npr;
  g.theta = d_acos(clampf(zr, T(-1), T(1)));
  g.dphi = (T(1) / static_cast<T>(npr)) * S<T>(kTwoPi);
  g.shift = shift;
  g.inv_dphi = T(1) / g.dphi;
  return g;
}

// the two ids of ring g bracketing phi and the fraction toward the second
template <typename T>
__device__ __forceinline__ void ring_pair(const Ring<T>& g, T phi, int& p1,
                                          int& p2, T& frac) {
  const T t = phi / g.dphi - g.shift;
  const int j1 = static_cast<int>(d_floor(t));
  frac = t - static_cast<T>(j1);
  p1 = g.start + remainder_i(j1, g.npr);
  p2 = g.start + remainder_i(j1 + 1, g.npr);
}

// what the adjoint needs of the forward besides ids and weights
template <typename T>
struct Terms {
  T x, y, z, r, c0, c, f1, f2, wt, wt0, denom, inv_dphi1, inv_dphi2;
  bool npole, spole;
  int ring1;  // the first pair's ring (clamped)
};

// the four ids and weights of the pixel moved to (vx + ox, vy + oy,
// vz + oz): runners/shell.py _regrid_shell's geometry and ops/healpix.py
// get_interp_weights_parts, op for op, each ring's terms read from the
// table
template <typename T>
__device__ __forceinline__ void corners(int n,
                                        const Ring<T>* __restrict__ rings,
                                        T vx, T vy, T vz, T ox, T oy, T oz,
                                        int p[4], T w[4], Terms<T>& tm) {
  const T x = vx + ox, y = vy + oy, z = vz + oz;
  const T r = d_sqrt(x * x + y * y + z * z);
  const T c0 = z / r;
  const T c = clampf(c0, T(-1), T(1));
  const T theta = d_acos(c);
  T phi = d_atan2(y, x);
  if (phi < T(0)) phi = phi + S<T>(kTwoPi);
  const T zc = d_cos(theta);
  const int r1 = z_to_ring(n, zc);
  const int r2 = r1 + 1;
  const bool npole = r1 < 1, spole = r2 > 4 * n - 1;
  const int r1c = clampi(r1, 1, 4 * n - 1);
  const Ring<T> g1 = rings[r1c];
  const Ring<T> g2 = rings[clampi(r2, 1, 4 * n - 1)];
  T f1, f2;
  ring_pair(g1, phi, p[0], p[1], f1);
  ring_pair(g2, phi, p[2], p[3], f2);
  const T denom = g2.theta > g1.theta ? g2.theta - g1.theta : T(1);
  const T wt0 = (theta - g1.theta) / denom;
  T wt = clampf(wt0, T(0), T(1));
  wt = npole ? T(0) : (spole ? T(1) : wt);
  const T a = T(1) - wt;
  w[0] = a * (T(1) - f1);
  w[1] = a * f1;
  w[2] = wt * (T(1) - f2);
  w[3] = wt * f2;
  tm = Terms<T>{x,     y,           z,           r,     c0,    c,
                f1,    f2,          wt,          wt0,   denom, g1.inv_dphi,
                g2.inv_dphi, npole, spole, r1c};
}

template <typename T>
struct In {
  const T *vx, *vy, *vz, *ox, *oy, *oz, *m;
};

template <typename T>
__device__ __forceinline__ void load_corners(const In<T>& in,
                                             const Ring<T>* __restrict__ r,
                                             long long i, int n, int p[4],
                                             T w[4], Terms<T>& tm) {
  corners<T>(n, r, in.vx[i], in.vy[i], in.vz[i], in.ox[i], in.oy[i],
             in.oz[i], p, w, tm);
}

// A warp's rows merged by destination, in four rounds. A lane's rows are
// two pairs, each of two ring neighbours (ids of each parity: a ring
// holds 4 i or 4 nside pixels, so a pair that wraps too pairs an odd id
// with an even one), the pairs on rings of each parity (r1 and r1 + 1).
// Round q presents from every lane the row on the ring of parity q / 2
// whose id has parity q % 2, so all the rows of one destination (one
// ring, one id) meet in the same round: __match_any_sync groups them, the
// lowest lane of a group sums the group's values through shared memory
// and adds the sum with one red.global.add. At the south pole both pairs
// lie on the last ring and the first pair's weights are 0: the second
// pair's rows are then presented in the other parity's rounds, correct
// but unmerged with their ring's other rows. A zero value adds nothing.
// Every lane of the warp calls it; returns the adds this lane issued.
template <typename T>
__device__ __forceinline__ int merge_rows(T* buf, int ring1, const int p[4],
                                          const T v[4], T* out) {
  const int lane = threadIdx.x & 31;
  int adds = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool first_pair = (ring1 & 1) == (q >> 1);
    const int a = first_pair ? p[0] : p[2], b = first_pair ? p[1] : p[3];
    const T va = first_pair ? v[0] : v[2], vb = first_pair ? v[1] : v[3];
    const bool take_a = (a & 1) == (q & 1);
    const T val = take_a ? va : vb;
    const int key = val != T(0) ? (take_a ? a : b) : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    buf[lane] = val;
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) {
      T s = val;
      for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1)
        s += buf[__ffs(rest) - 1];
      atomicAdd(out + key, s);
      ++adds;
    }
    __syncwarp();
  }
  return adds;
}

// the warp's sum of ``n`` added to *tally by its first lane
__device__ __forceinline__ void add_tally(unsigned long long* tally,
                                          int n) {
  const unsigned s = __reduce_add_sync(kFull, static_cast<unsigned>(n));
  if ((threadIdx.x & 31) == 0 && s)
    atomicAdd(tally, static_cast<unsigned long long>(s));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
regrid_rings_kernel(int nside, Ring<T>* __restrict__ rings) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < 4 * nside) rings[i] = ring_row<T>(nside, i);
}

// The kernels that add read the mass before the corners: read after
// them, it made ptxas spill a register around the call of the float64
// cos's slow path. A warp wholly past the end leaves; the lanes of a
// warp that holds the end take no pixel but join the merge.
template <typename T>
__global__ void __launch_bounds__(kThreads)
regrid_kernel(In<T> in, const Ring<T>* __restrict__ rings, int nside,
              long long n_in, T* __restrict__ out,
              unsigned long long* __restrict__ tally) {
  __shared__ T buf[kWarps][32];
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i - (threadIdx.x & 31) >= n_in) return;
  int p[4] = {0, 0, 0, 0};
  T v[4] = {T(0), T(0), T(0), T(0)};
  int ring1 = 0;
  if (i < n_in) {
    const T m = in.m[i];
    T w[4];
    Terms<T> tm;
    load_corners(in, rings, i, nside, p, w, tm);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = w[k] * m;
    ring1 = tm.ring1;
  }
  const int adds = merge_rows(buf[threadIdx.x >> 5], ring1, p, v, out);
  if (tally != nullptr) add_tally(tally, adds);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
regrid_parts_kernel(In<T> in, const Ring<T>* __restrict__ rings, int nside,
                    long long n_in, long long* __restrict__ ids,
                    T* __restrict__ wts) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_in) return;
  int p[4];
  T w[4];
  Terms<T> tm;
  load_corners(in, rings, i, nside, p, w, tm);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ids[k * n_in + i] = p[k];
    wts[k * n_in + i] = w[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
regrid_vjp_kernel(In<T> in, const Ring<T>* __restrict__ rings, int nside,
                  long long n_in, const T* __restrict__ ct,
                  T* __restrict__ dox, T* __restrict__ doy,
                  T* __restrict__ doz, T* __restrict__ dm) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_in) return;
  int p[4];
  T w[4];
  Terms<T> t;
  load_corners(in, rings, i, nside, p, w, t);
  T g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = ct[p[k]];
  const T m = in.m[i];
  if (dm != nullptr)
    dm[i] = w[0] * g[0] + w[1] * g[1] + w[2] * g[2] + w[3] * g[3];
  T dw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) dw[k] = m * g[k];
  const T d_wt = -((T(1) - t.f1) * dw[0]) - t.f1 * dw[1] +
                 (T(1) - t.f2) * dw[2] + t.f2 * dw[3];
  const T d_f1 = (T(1) - t.wt) * (dw[1] - dw[0]);
  const T d_f2 = t.wt * (dw[3] - dw[2]);
  const bool inside =
      t.wt0 >= T(0) && t.wt0 <= T(1) && !t.npole && !t.spole;
  const T d_th = inside ? d_wt / t.denom : T(0);
  // d f / d phi = 1 / dphi: a product with the table's reciprocal (the
  // plain version divides; within a rounding of it)
  const T d_phi = d_f1 * t.inv_dphi1 + d_f2 * t.inv_dphi2;
  // d acos(c) / dc = -1 / sqrt(1 - c^2), passed where z / r is inside
  // the clamp (inclusive, as torch.clamp's backward)
  const bool c_in = t.c0 >= T(-1) && t.c0 <= T(1);
  const T d_c0 =
      c_in ? d_th * -(T(1) / d_sqrt(T(1) - t.c * t.c)) : T(0);
  const T r3 = t.r * t.r * t.r;
  const T rho2 = t.x * t.x + t.y * t.y;
  dox[i] = d_c0 * (-t.z * t.x / r3) + d_phi * (-t.y / rho2);
  doy[i] = d_c0 * (-t.z * t.y / r3) + d_phi * (t.x / rho2);
  doz[i] = d_c0 * (T(1) / t.r - t.z * t.z / r3);
}

// ----- the deterministic route -----

template <typename T>
__global__ void __launch_bounds__(kThreads)
regrid_count_kernel(In<T> in, const Ring<T>* __restrict__ rings, int nside,
                    long long n_in, int* __restrict__ count) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_in) return;
  const T m = in.m[i];
  int p[4];
  T w[4];
  Terms<T> tm;
  load_corners(in, rings, i, nside, p, w, tm);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (w[k] * m != T(0)) atomicAdd(count + p[k], 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
regrid_fill_kernel(In<T> in, const Ring<T>* __restrict__ rings, int nside,
                   long long n_in, unsigned long long* __restrict__ cursor,
                   uint32_t* __restrict__ keys, T* __restrict__ vals) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_in) return;
  const T m = in.m[i];
  int p[4];
  T w[4];
  Terms<T> tm;
  load_corners(in, rings, i, nside, p, w, tm);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T v = w[k] * m;
    if (v != T(0)) {
      const unsigned long long at = atomicAdd(cursor + p[k], 1ull);
      keys[at] = static_cast<uint32_t>(4 * i + k);
      vals[at] = v;
    }
  }
}

// the first L of N (key, value) rows sorted by key in registers (the rest
// padded with the largest key, which sorts last), summed in key order
template <int N, typename T>
__device__ __forceinline__ T sorted_sum(const uint32_t* keys, const T* vals,
                                        long long b, int L) {
  uint32_t k[N];
  T v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    k[j] = j < L ? keys[b + j] : 0xffffffffu;
    v[j] = j < L ? vals[b + j] : T(0);
  }
#pragma unroll
  for (int round = 0; round < N; ++round) {
#pragma unroll
    for (int j = round & 1; j + 1 < N; j += 2) {
      if (k[j] > k[j + 1]) {
        const uint32_t tk = k[j];
        k[j] = k[j + 1];
        k[j + 1] = tk;
        const T tv = v[j];
        v[j] = v[j + 1];
        v[j + 1] = tv;
      }
    }
  }
  T s = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (j < L) s += v[j];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
regrid_sum_kernel(long long npix, const int* __restrict__ count,
                  const unsigned long long* __restrict__ end,
                  const uint32_t* __restrict__ keys,
                  const T* __restrict__ vals, int* __restrict__ long_list,
                  int* __restrict__ n_long, T* __restrict__ out) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= npix) return;
  const int L = count[p];
  const long long b = static_cast<long long>(end[p]) - L;
  if (L == 0) {
    out[p] = T(0);
  } else if (L <= 2) {  // a + b == b + a: no order to fix
    out[p] = L == 1 ? vals[b] : vals[b] + vals[b + 1];
  } else if (L <= 4) {
    out[p] = sorted_sum<4>(keys, vals, b, L);
  } else if (L <= 8) {
    out[p] = sorted_sum<8>(keys, vals, b, L);
  } else if (L <= kRegisterRows) {
    out[p] = sorted_sum<kRegisterRows>(keys, vals, b, L);
  } else {
    long_list[atomicAdd(n_long, 1)] = static_cast<int>(p);
  }
}

// compare-exchange of rows a < b: the smaller key to a
template <typename T>
__device__ __forceinline__ void exchange(uint32_t* k, T* v, int a, int b) {
  const uint32_t ka = k[a], kb = k[b];
  if (ka > kb) {
    k[a] = kb;
    k[b] = ka;
    const T va = v[a];
    v[a] = v[b];
    v[b] = va;
  }
}

// a warp sorts L rows by key: the bitonic network for the next power of
// two P with every comparator ascending (the first step of each merge
// compares mirrored rows), so the rows past L (as if of the largest key)
// never move and their comparators are dropped
template <typename T>
__device__ void warp_sort(uint32_t* k, T* v, int L, int lane) {
  int P = 1;
  while (P < L) P <<= 1;
  for (int size = 2; size <= P; size <<= 1) {
    const int half = size >> 1;
    for (int q = lane; q < P / 2; q += 32) {
      const int a = (q / half) * size + (q % half);
      const int b = a ^ (size - 1);
      if (b < L) exchange(k, v, a, b);
    }
    __syncwarp();
    for (int h = half >> 1; h >= 1; h >>= 1) {
      for (int q = lane; q < P / 2; q += 32) {
        const int a = (q / h) * (2 * h) + (q % h);
        const int b = a + h;
        if (b < L) exchange(k, v, a, b);
      }
      __syncwarp();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLongWarps * 32)
regrid_long_kernel(const int* __restrict__ count,
                   const unsigned long long* __restrict__ end,
                   uint32_t* keys, T* vals, const int* __restrict__ long_list,
                   const int* __restrict__ n_long, T* __restrict__ out) {
  __shared__ uint32_t sk[kLongWarps][kWarpCap];
  __shared__ T sv[kLongWarps][kWarpCap];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int total = *n_long;
  for (int s = blockIdx.x * kLongWarps + wid; s < total;
       s += gridDim.x * kLongWarps) {
    const int p = long_list[s];
    const int L = count[p];
    const long long b = static_cast<long long>(end[p]) - L;
    uint32_t* k = keys + b;
    T* v = vals + b;
    if (L <= kWarpCap) {
      for (int j = lane; j < L; j += 32) {
        sk[wid][j] = k[j];
        sv[wid][j] = v[j];
      }
      __syncwarp();
      k = sk[wid];
      v = sv[wid];
    }
    warp_sort(k, v, L, lane);
    if (lane == 0) {
      T acc = v[0];
      for (int j = 1; j < L; ++j) acc += v[j];
      out[p] = acc;
    }
    __syncwarp();
  }
}

long long blocks_for(long long n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
In<T> inputs(const void* const* planes) {
  return In<T>{static_cast<const T*>(planes[0]),
               static_cast<const T*>(planes[1]),
               static_cast<const T*>(planes[2]),
               static_cast<const T*>(planes[3]),
               static_cast<const T*>(planes[4]),
               static_cast<const T*>(planes[5]),
               static_cast<const T*>(planes[6])};
}

template <typename T>
const Ring<T>* ring_table(const void* rings) {
  return static_cast<const Ring<T>*>(rings);
}

template <typename T>
int launch_rings(int nside, void* rings, cudaStream_t stream) {
  regrid_rings_kernel<T><<<blocks_for(4LL * nside), kThreads, 0, stream>>>(
      nside, static_cast<Ring<T>*>(rings));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_regrid(int nside, long long n_in, const void* const* planes,
                  const void* rings, void* out, void* tally,
                  cudaStream_t stream) {
  regrid_kernel<T><<<blocks_for(n_in), kThreads, 0, stream>>>(
      inputs<T>(planes), ring_table<T>(rings), nside, n_in,
      static_cast<T*>(out), static_cast<unsigned long long*>(tally));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_parts(int nside, long long n_in, const void* const* planes,
                 const void* rings, void* ids, void* wts,
                 cudaStream_t stream) {
  regrid_parts_kernel<T><<<blocks_for(n_in), kThreads, 0, stream>>>(
      inputs<T>(planes), ring_table<T>(rings), nside, n_in,
      static_cast<long long*>(ids), static_cast<T*>(wts));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vjp(int nside, long long n_in, const void* const* planes,
               const void* rings, const void* ct, void* dox, void* doy,
               void* doz, void* dm, cudaStream_t stream) {
  regrid_vjp_kernel<T><<<blocks_for(n_in), kThreads, 0, stream>>>(
      inputs<T>(planes), ring_table<T>(rings), nside, n_in,
      static_cast<const T*>(ct), static_cast<T*>(dox), static_cast<T*>(doy),
      static_cast<T*>(doz), static_cast<T*>(dm));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_count(int nside, long long n_in, const void* const* planes,
                 const void* rings, void* count, cudaStream_t stream) {
  regrid_count_kernel<T><<<blocks_for(n_in), kThreads, 0, stream>>>(
      inputs<T>(planes), ring_table<T>(rings), nside, n_in,
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fill(int nside, long long n_in, const void* const* planes,
                const void* rings, void* cursor, void* keys, void* vals,
                cudaStream_t stream) {
  regrid_fill_kernel<T><<<blocks_for(n_in), kThreads, 0, stream>>>(
      inputs<T>(planes), ring_table<T>(rings), nside, n_in,
      static_cast<unsigned long long*>(cursor), static_cast<uint32_t*>(keys),
      static_cast<T*>(vals));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sum(long long npix, const void* count, const void* end,
               void* keys, void* vals, void* long_list, void* n_long,
               void* out, cudaStream_t stream) {
  regrid_sum_kernel<T><<<blocks_for(npix), kThreads, 0, stream>>>(
      npix, static_cast<const int*>(count),
      static_cast<const unsigned long long*>(end),
      static_cast<const uint32_t*>(keys), static_cast<const T*>(vals),
      static_cast<int*>(long_list), static_cast<int*>(n_long),
      static_cast<T*>(out));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  regrid_long_kernel<T><<<2 * sms, kLongWarps * 32, 0, stream>>>(
      static_cast<const int*>(count),
      static_cast<const unsigned long long*>(end),
      static_cast<uint32_t*>(keys), static_cast<T*>(vals),
      static_cast<const int*>(long_list), static_cast<const int*>(n_long),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REGRID_ENTRIES(SFX, T)                                               \
  extern "C" int regrid_ring_bytes_##SFX() {                                 \
    return static_cast<int>(sizeof(Ring<T>));                                \
  }                                                                          \
  extern "C" int regrid_rings_##SFX(int nside, void* rings, void* stream) {  \
    return launch_rings<T>(nside, rings, static_cast<cudaStream_t>(stream)); \
  }                                                                          \
  extern "C" int regrid_##SFX(int nside, long long n_in,                     \
                              const void* const* planes, const void* rings,  \
                              void* out, void* tally, void* stream) {        \
    return launch_regrid<T>(nside, n_in, planes, rings, out, tally,          \
                            static_cast<cudaStream_t>(stream));              \
  }                                                                          \
  extern "C" int regrid_parts_##SFX(int nside, long long n_in,               \
                                    const void* const* planes,               \
                                    const void* rings, void* ids, void* wts, \
                                    void* stream) {                          \
    return launch_parts<T>(nside, n_in, planes, rings, ids, wts,             \
                           static_cast<cudaStream_t>(stream));               \
  }                                                                          \
  extern "C" int regrid_vjp_##SFX(int nside, long long n_in,                 \
                                  const void* const* planes,                 \
                                  const void* rings, const void* ct,         \
                                  void* dox, void* doy, void* doz, void* dm, \
                                  void* stream) {                            \
    return launch_vjp<T>(nside, n_in, planes, rings, ct, dox, doy, doz, dm,  \
                         static_cast<cudaStream_t>(stream));                 \
  }                                                                          \
  extern "C" int regrid_count_##SFX(int nside, long long n_in,               \
                                    const void* const* planes,               \
                                    const void* rings, void* count,          \
                                    void* stream) {                          \
    return launch_count<T>(nside, n_in, planes, rings, count,                \
                           static_cast<cudaStream_t>(stream));               \
  }                                                                          \
  extern "C" int regrid_fill_##SFX(int nside, long long n_in,                \
                                   const void* const* planes,                \
                                   const void* rings, void* cursor,          \
                                   void* keys, void* vals, void* stream) {   \
    return launch_fill<T>(nside, n_in, planes, rings, cursor, keys, vals,    \
                          static_cast<cudaStream_t>(stream));                \
  }                                                                          \
  extern "C" int regrid_sum_##SFX(long long npix, const void* count,         \
                                  const void* end, void* keys, void* vals,   \
                                  void* long_list, void* n_long, void* out,  \
                                  void* stream) {                            \
    return launch_sum<T>(npix, count, end, keys, vals, long_list, n_long,    \
                         out, static_cast<cudaStream_t>(stream));            \
  }

REGRID_ENTRIES(f32, float)
REGRID_ENTRIES(f64, double)
