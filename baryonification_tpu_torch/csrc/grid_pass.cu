// Cell-major grid pass for Hopper (sm_90a): one bucket of halos summed
// onto every voxel (3D) or pixel (2D) of a periodic grid, in block-major
// order, and the pass's adjoint with respect to the halos' radial rows.
//
// Replaces the candidate loop of the JAX package's grid_offsets_pass,
// grid_paint_pass, grid_offsets_pass_2d and grid_paint_pass_2d
// (baryonification_tpu/runners/grid_cellmajor.py:317, :408, :638, :820),
// which are XLA there (no TPU kernel): for each chunk of blocks and each
// candidate slot they rebuild the halo's radial row with one-hot matmuls
// and read it with a segment or hat reduction. Here the row of every halo
// of the bucket is blended once beforehand (runners/grid_cellmajor.py
// halo_rows, H x n_hi values) and a slot reads two nodes of it. The
// gradient of those passes is XLA autodiff of the same loop; grid_vjp is
// its first order in the rows.
//
// The voxels of a bucket are its ncell Morton blocks of F = B^dim voxels,
// block ids block0 .. block0 + ncell - 1, the voxel of position c F + f at
// per-axis offsets f = (ox B + oy) B + oz of block block0 + c. What one
// voxel computes, over the first counts[c] candidates h = dense[c K + k]
// of its block, in slot order (the plain version: runners/grid_cellmajor.py
// _GridBucket.geometry and .values, stepped by _bucket_pass):
//   u_d  = (iv_d - lo[h, d]) mod N      its place in the halo's window
//   dx_d = (u_d - half) res - rec[h, d] its offset from the halo
//   r_c  = |dx|; in 2D r = |Rm dx| (the shear to the elliptical frame),
//          in 3D r = r_c
//   rad  = log(max(r, 1e-30)), less ln R_com (rec[h, dim + 1]) in rdelta
//   t = (rad - g0) / dg,  i = clamp(floor t, 0, n_hi - 2),  w = t - i
//   live = g0 <= rad <= rad_hi and r < reach (rec[h, dim]) and every
//          u_d < 2 half
//   v = lerp(rows[h, i], rows[h, i + 1], w)   (torch.lerp's two branches)
//   paint:   out += exp(v)                         where live, exp(v) finite
//   offsets: out_d += (v / res) / max(r_c, 1e-30) dx_d   where live, v finite
// Rows of halos outside the table's grid are NaN and paint nodes outside
// the profile's range -1e30, so those slots add nothing.
//
// grid_vjp, for cotangent planes ct_d of the outputs: each live slot with a
// finite value adds g (1 - w) and g w to nodes i and i + 1 of its halo's
// row, g = ct exp(v) (paint) or ((sum_d ct_d dx_d) / max(r_c, 1e-30)) / res
// (offsets): what autograd of the plain version gives, in its order of
// operations (the backward of torch.lerp is g (1 - w), g w).
//
// What bounds it: operations, not bytes. Each voxel's planes are written
// once; the candidate lists, the per-halo records and the rows are small
// and read from L1/L2; every listed voxel-slot pays the window and radius
// tests (grid-256's largest bucket lists 2.8e8 of them, a third inside).
// This first design is one thread a voxel, the grid sized by the voxels,
// so B (4 to 64) sets no shape; the thread walks its block's candidates in
// slot order with no cull, keeps its sums in registers and writes each
// output element once: no atomics, no sort. The window place takes one
// compare and add where |iv - lo| < N (always, for a window of at most N),
// and an integer remainder otherwise; a slot outside its halo's window
// skips the square root and log. Where F < 32 (2D, B = 4: F = 16) a
// warp spans two blocks and their two candidate lists. The adjoint makes
// one global atomic add (red.global.add) a node a slot inside.
//
// Both entries take an optional tally: voxel-slots listed, voxel-slots
// inside (live), and the adjoint's global atomics, summed a block at a time
// and added with one atomic a block. The source is built without FMA
// contraction (_cuda_build.py), so each slot's arithmetic rounds as the
// plain version's (its sums are taken in another order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct PassArgs {
  const T* hrec;            // (H, hcols): offsets, reach, [lnR], [Rm x 4]
  const long long* lo;      // (H, dim): each halo's window start
  const long long* dense;   // (ncell, k_pad) candidate halo ids
  const long long* counts;  // (ncell,)
  const T* rows;            // (H, n_hi)
  const T* ct[3];           // adjoint: cotangent planes (ncell F each)
  T* out[3];                // pass: output planes; adjoint: out[0] = d_rows
  long long ncell, k_pad, block0;
  int B, N, half, n_hi, hcols;
  T res, g0, dg, rad_hi;
  unsigned long long* tally;  // null, or {slots, inside, atomics}
};

// Morton id -> block coordinates (the inverse of the spread that makes
// the ids: every third bit in 3D, every other bit in 2D)
__device__ __forceinline__ long long compact3(unsigned long long v) {
  v &= 0x09249249ULL;
  v = (v | (v >> 2)) & 0x030C30C3ULL;
  v = (v | (v >> 4)) & 0x0300F00FULL;
  v = (v | (v >> 8)) & 0x030000FFULL;
  return static_cast<long long>((v | (v >> 16)) & 0x000003FFULL);
}
__device__ __forceinline__ long long compact2(unsigned long long v) {
  v &= 0x55555555ULL;
  v = (v | (v >> 1)) & 0x33333333ULL;
  v = (v | (v >> 2)) & 0x0F0F0F0FULL;
  v = (v | (v >> 4)) & 0x00FF00FFULL;
  return static_cast<long long>((v | (v >> 8)) & 0x0000FFFFULL);
}

// the voxel's per-axis grid coordinates
template <int DIM>
__device__ __forceinline__ void voxel_coords(long long b, int f, int B,
                                             long long (&iv)[DIM]) {
  if (DIM == 3) {
    const unsigned long long u = static_cast<unsigned long long>(b);
    iv[0] = compact3(u) * B + f / (B * B);
    iv[1] = compact3(u >> 1) * B + (f / B) % B;
    iv[DIM - 1] = compact3(u >> 2) * B + f % B;
  } else {
    const unsigned long long u = static_cast<unsigned long long>(b);
    iv[0] = compact2(u) * B + f / B;
    iv[DIM - 1] = compact2(u >> 1) * B + f % B;
  }
}

// (a - b) mod n in [0, n), as torch.remainder of int64 for n > 0
__device__ __forceinline__ long long wrap(long long a, long long n) {
  if (a < 0) a += n;
  else if (a >= n) a -= n;
  if (a < 0 || a >= n) {
    a %= n;
    if (a < 0) a += n;
  }
  return a;
}

// torch.lerp (ATen's Lerp.h): the weight's half decides the form
template <typename T>
__device__ __forceinline__ T lerp(T a, T b, T w) {
  return fabs(w) < T(0.5) ? a + w * (b - a) : b - (b - a) * (T(1) - w);
}

// where a slot lands: its offsets, circular radius, node and weight
template <typename T, int DIM>
struct Slot {
  T dx[DIM];
  T r_c, w;
  long long base;
};

// the geometry of slot h at voxel iv: true where it is live
template <typename T, int DIM, bool kRdelta>
__device__ __forceinline__ bool slot_geometry(const PassArgs<T>& A,
                                              long long h,
                                              const long long (&iv)[DIM],
                                              Slot<T, DIM>& s) {
  const T* rec = A.hrec + h * A.hcols;
  const long long* lo = A.lo + h * DIM;
  bool win = true;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const long long u = wrap(iv[d] - __ldg(lo + d), A.N);
    s.dx[d] = static_cast<T>(u - A.half) * A.res - __ldg(rec + d);
    win = win && u < 2LL * A.half;
  }
  // the window test first: live is a conjunction, so a slot outside the
  // window is rejected before its square root and log, with the same
  // result
  if (!win) return false;
  T sq = s.dx[0] * s.dx[0] + s.dx[1] * s.dx[1];
  if (DIM == 3) sq = sq + s.dx[DIM - 1] * s.dx[DIM - 1];
  s.r_c = sqrt(sq);
  T r = s.r_c;
  if (DIM == 2) {
    const T* rm = rec + DIM + 1 + (kRdelta ? 1 : 0);
    const T ex = __ldg(rm) * s.dx[0] + __ldg(rm + 2) * s.dx[DIM - 1];
    const T ey = __ldg(rm + 1) * s.dx[0] + __ldg(rm + 3) * s.dx[DIM - 1];
    r = sqrt(ex * ex + ey * ey);
  }
  T rad = log(fmax(r, static_cast<T>(1e-30)));
  if (kRdelta) rad = rad - __ldg(rec + DIM + 1);
  if (!(rad >= A.g0 && rad <= A.rad_hi && r < __ldg(rec + DIM)))
    return false;
  const T t = (rad - A.g0) / A.dg;
  const T i = fmin(fmax(floor(t), T(0)), static_cast<T>(A.n_hi - 2));
  s.w = t - i;
  s.base = h * A.n_hi + static_cast<long long>(i);
  return true;
}

// the tally's counts of a block, added with one atomic a count
__device__ __forceinline__ void add_tally(unsigned long long* tally,
                                          unsigned long long slots,
                                          unsigned long long inside,
                                          unsigned long long atomics) {
  __shared__ unsigned long long part[3][kThreads / 32];
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    slots += __shfl_down_sync(full, slots, off);
    inside += __shfl_down_sync(full, inside, off);
    atomics += __shfl_down_sync(full, atomics, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = slots;
    part[1][warp] = inside;
    part[2][warp] = atomics;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long s = 0;
    for (int j = 0; j < kThreads / 32; ++j) s += part[threadIdx.x][j];
    if (s != 0) atomicAdd(tally + threadIdx.x, s);
  }
}

// one thread a voxel: the pass (kVjp false) sums its slots in registers
// and writes each plane once; the adjoint (kVjp true) reads its cotangents
// and adds each live finite slot's two node shares to d_rows (out[0])
template <typename T, int DIM, int kMode, bool kVjp>
__global__ void __launch_bounds__(kThreads)
grid_kernel(PassArgs<T> A) {
  constexpr bool kPaint = kMode == 2, kRdelta = kMode == 1;
  constexpr int kPlanes = kPaint ? 1 : DIM;
  const int F = DIM == 3 ? A.B * A.B * A.B : A.B * A.B;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool active = p < A.ncell * F;
  unsigned long long n_slots = 0, n_in = 0, n_atomics = 0;
  if (active) {
    const long long c = p / F;
    long long iv[DIM];
    voxel_coords<DIM>(A.block0 + c, static_cast<int>(p - c * F), A.B, iv);
    const long long cnt = __ldg(A.counts + c);
    const long long* ids = A.dense + c * A.k_pad;
    // the pass's sums, or the adjoint's cotangents
    T acc[kPlanes];
#pragma unroll
    for (int j = 0; j < kPlanes; ++j)
      acc[j] = kVjp ? __ldg(A.ct[j] + p) : T(0);
    for (long long k = 0; k < cnt; ++k) {
      Slot<T, DIM> s;
      if (!slot_geometry<T, DIM, kRdelta>(A, __ldg(ids + k), iv, s))
        continue;
      ++n_in;
      const T v = lerp(__ldg(A.rows + s.base), __ldg(A.rows + s.base + 1),
                       s.w);
      if constexpr (kVjp) {
        T g;
        if (kPaint) {
          const T e = exp(v);
          if (!isfinite(e)) continue;
          g = acc[0] * e;
        } else {
          if (!isfinite(v)) continue;
          T gs = acc[0] * s.dx[0];
#pragma unroll
          for (int j = 1; j < kPlanes; ++j) gs = gs + acc[j] * s.dx[j];
          g = (gs / fmax(s.r_c, static_cast<T>(1e-30))) / A.res;
        }
        atomicAdd(A.out[0] + s.base, g * (T(1) - s.w));
        atomicAdd(A.out[0] + s.base + 1, g * s.w);
        n_atomics += 2;
      } else if (kPaint) {
        const T e = exp(v);
        if (isfinite(e)) acc[0] = acc[0] + e;
      } else if (isfinite(v)) {
        const T scale = (v / A.res) / fmax(s.r_c, static_cast<T>(1e-30));
#pragma unroll
        for (int j = 0; j < kPlanes; ++j) acc[j] = acc[j] + scale * s.dx[j];
      }
    }
    n_slots = static_cast<unsigned long long>(cnt);
    if constexpr (!kVjp) {
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) A.out[j][p] = acc[j];
    }
  }
  if (A.tally != nullptr) add_tally(A.tally, n_slots, n_in, n_atomics);
}

template <typename T, int DIM, int kMode>
void launch_one(bool vjp, unsigned grid, cudaStream_t s,
                const PassArgs<T>& A) {
  if (vjp)
    grid_kernel<T, DIM, kMode, true><<<grid, kThreads, 0, s>>>(A);
  else
    grid_kernel<T, DIM, kMode, false><<<grid, kThreads, 0, s>>>(A);
}

template <typename T, int DIM>
void launch_dim(int mode, bool vjp, unsigned grid, cudaStream_t s,
                const PassArgs<T>& A) {
  if (mode == 0)
    launch_one<T, DIM, 0>(vjp, grid, s, A);
  else if (mode == 1)
    launch_one<T, DIM, 1>(vjp, grid, s, A);
  else
    launch_one<T, DIM, 2>(vjp, grid, s, A);
}

template <typename T>
int launch(bool vjp, int mode, int dim, const void* hrec, const void* lo,
           const void* dense, const void* counts, const void* rows,
           const void* c0, const void* c1, const void* c2, void* o0, void* o1,
           void* o2, long long ncell, long long k_pad, long long block0,
           int B, int N, int half, int n_hi, int hcols, double res,
           double g0, double dg, double rad_hi, void* tally, void* stream) {
  if ((dim != 2 && dim != 3) || mode < 0 || mode > 2 || B < 1 || N < 1 ||
      half < 0 || n_hi < 2 || k_pad < 0 || ncell < 0 || block0 < 0 ||
      hcols < dim + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long F = dim == 3 ? 1LL * B * B * B : 1LL * B * B;
  const long long n = ncell * F;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  PassArgs<T> A;
  A.hrec = static_cast<const T*>(hrec);
  A.lo = static_cast<const long long*>(lo);
  A.dense = static_cast<const long long*>(dense);
  A.counts = static_cast<const long long*>(counts);
  A.rows = static_cast<const T*>(rows);
  A.ct[0] = static_cast<const T*>(c0);
  A.ct[1] = static_cast<const T*>(c1);
  A.ct[2] = static_cast<const T*>(c2);
  A.out[0] = static_cast<T*>(o0);
  A.out[1] = static_cast<T*>(o1);
  A.out[2] = static_cast<T*>(o2);
  A.ncell = ncell;
  A.k_pad = k_pad;
  A.block0 = block0;
  A.B = B;
  A.N = N;
  A.half = half;
  A.n_hi = n_hi;
  A.hcols = hcols;
  A.res = static_cast<T>(res);
  A.g0 = static_cast<T>(g0);
  A.dg = static_cast<T>(dg);
  A.rad_hi = static_cast<T>(rad_hi);
  A.tally = static_cast<unsigned long long*>(tally);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (dim == 3)
    launch_dim<T, 3>(mode, vjp, grid, s, A);
  else
    launch_dim<T, 2>(mode, vjp, grid, s, A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers.
// mode: 0 offsets, 1 offsets with the radial axis in units of R_com
// (rdelta), 2 paint; dim 2 or 3. hrec (H, hcols), lo (H, dim) int64, dense
// (ncell, k_pad) int64, counts (ncell,) int64, rows (H, n_hi).
// grid_pass: o0..o2 the output planes (ncell B^dim each; dim of them in
// the offsets modes, one in paint), written, not added to; c0..c2 unused.
// grid_vjp: c0..c2 the cotangent planes, o0 the (H, n_hi) d_rows, added
// to with atomics. tally: null, or three uint64 (voxel-slots listed,
// voxel-slots inside, global atomics) added to. Returns cudaGetLastError()
// of the launch (0 on success); the launch is asynchronous on `stream`.
#define GRID_ENTRY(NAME, T, VJP)                                             \
  extern "C" int NAME(int mode, int dim, const void* hrec, const void* lo,   \
                      const void* dense, const void* counts,                 \
                      const void* rows, const void* c0, const void* c1,      \
                      const void* c2, void* o0, void* o1, void* o2,          \
                      long long ncell, long long k_pad, long long block0,    \
                      int B, int N, int half, int n_hi, int hcols,           \
                      double res, double g0, double dg, double rad_hi,       \
                      void* tally, void* stream) {                           \
    return launch<T>(VJP, mode, dim, hrec, lo, dense, counts, rows, c0, c1,  \
                     c2, o0, o1, o2, ncell, k_pad, block0, B, N, half, n_hi, \
                     hcols, res, g0, dg, rad_hi, tally, stream);             \
  }

GRID_ENTRY(grid_pass_f32, float, false)
GRID_ENTRY(grid_pass_f64, double, false)
GRID_ENTRY(grid_vjp_f32, float, true)
GRID_ENTRY(grid_vjp_f64, double, true)
