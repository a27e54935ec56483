// Cell-major shell pass for Hopper (sm_90a): one bucket of halos summed
// onto every pixel of the sky, pixels in NESTED order.
//
// Replaces the per-cell candidate loop of the JAX package's
// cellmajor_offsets_pass and cellmajor_paint_pass
// (baryonification_tpu/runners/shell_cellmajor.py:255 and :372). There the
// loop is XLA: for each chunk of cells and each candidate slot it rebuilds
// the halo's radial row with one-hot matmuls and reads it with a hat-basis
// reduction, because a gather costs ~10 ns a row on the TPU. On this card a
// gather from L1/L2 is cheap, so the row of every halo of the bucket is
// blended once beforehand (H x n_hi values) and a slot reads two nodes of it.
//
// What one pixel p (cell c = p / F) computes, over the first counts[c]
// candidates h = dense[c * k_pad + k] of its cell, in slot order:
//   offsets mode: the three components of the cancellation-stable
//     unit-vector delta of the pixel moved by the halo's displacement
//     d(r) (read at ln r, or ln r - ln R_com with rdelta);
//   paint mode: exp of the log profile read at ln r.
// A slot adds nothing where the pixel lies outside the halo's disc
// (r_com >= eps_max R_com, or the angular test), outside the row's radial
// range [g0, rad_hi], or where the value is not finite (rows of halos
// outside the table's grid are NaN). The sums are added once to the
// output planes.
//
// Design: one thread a pixel, the grid sized by the pixels, so F (4 to
// millions) sets no shape; the F pixels of a cell are neighbours, so the
// cell's candidate ids, the halos' 8-value records and their rows are read
// by all of them from L1/L2. Sums stay in registers; every pixel is written
// by its own thread once: no atomics, no sort. The arithmetic is the plain
// version's (ops/cellmajor_cuda.py), operation for operation; the source is
// built without FMA contraction (_cuda_build.py), so it rounds as the plain
// version does.
//
// Bound: the work per (pixel, slot) is ~40 flops plus a log and a sqrt
// (offsets: two sqrt and three divisions more; paint: an exp), so for the
// shell path's buckets it is bound by operations, not bytes: each pixel's
// planes are read and written once, the records and rows are small.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T t_sqrt(T x) { return sqrt(x); }
template <typename T>
__device__ __forceinline__ T t_log(T x) { return log(x); }
template <typename T>
__device__ __forceinline__ T t_exp(T x) { return exp(x); }

template <typename T>
__device__ __forceinline__ bool finite(T x) { return isfinite(x); }

template <typename T, bool kPaint, bool kRdelta>
__global__ void __launch_bounds__(kThreads)
cellmajor_kernel(const T* __restrict__ px, const T* __restrict__ py,
                 const T* __restrict__ pz, const int32_t* __restrict__ dense,
                 const int32_t* __restrict__ counts,
                 const T* __restrict__ recs, const T* __restrict__ rows,
                 T* __restrict__ o0, T* __restrict__ o1, T* __restrict__ o2,
                 long long npix, long long F, int k_pad, int n_hi, T g0,
                 T dg, T rad_hi) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= npix) return;
  const long long c = p / F;
  const int cnt = counts[c];
  if (cnt <= 0) return;
  const T x = px[p], y = py[p], z = pz[p];
  const int32_t* hids = dense + c * k_pad;
  const T tmax = static_cast<T>(n_hi - 1);
  const T tiny = static_cast<T>(1e-30);
  T ax = 0, ay = 0, az = 0;
  for (int k = 0; k < cnt; ++k) {
    const int h = __ldg(hids + k);
    const T* r = recs + static_cast<long long>(h) * 8;
    const T hvx = __ldg(r + 0), hvy = __ldg(r + 1), hvz = __ldg(r + 2);
    const T hD = __ldg(r + 3), ha = __ldg(r + 4), hReps = __ldg(r + 5);
    const T cosr = __ldg(r + 7);
    const T dx = (x - hvx) * hD;
    const T dy = (y - hvy) * hD;
    const T dz = (z - hvz) * hD;
    const T r_sep = t_sqrt(dx * dx + dy * dy + dz * dz);
    T r_com, rad;
    if (kPaint) {
      r_com = fmax(r_sep / ha, tiny);
      rad = t_log(r_com);
    } else {
      r_com = r_sep / ha;
      rad = t_log(fmax(r_com, tiny));
      if (kRdelta) rad = rad - __ldg(r + 6);
    }
    const T cosang = x * hvx + y * hvy + z * hvz;
    if (!(rad >= g0 && rad <= rad_hi && r_com < hReps && cosang >= cosr))
      continue;
    // lerp between two nodes of the halo's row (t clipped to the row)
    const T t = (rad - g0) / dg;
    const T tc = fmin(fmax(t, T(0)), tmax);
    int i = static_cast<int>(floor(tc));
    i = min(max(i, 0), n_hi - 2);
    const T w = tc - static_cast<T>(i);
    const T* row = rows + static_cast<long long>(h) * n_hi;
    const T v = (T(1) - w) * __ldg(row + i) + w * __ldg(row + i + 1);
    if (kPaint) {
      const T paint = t_exp(v);
      if (finite(paint)) ax = ax + paint;
      continue;
    }
    if (!finite(v)) continue;
    const T d = v * ha;                                  // physical
    const T scale = d / fmax(r_sep, tiny);
    const T ofx = scale * dx;
    const T ofy = scale * dy;
    const T ofz = scale * dz;
    const T nwx = x * hD + ofx;
    const T nwy = y * hD + ofy;
    const T nwz = z * hD + ofz;
    const T nw_norm = t_sqrt(nwx * nwx + nwy * nwy + nwz * nwz);
    const T pdo = hD * (x * ofx + y * ofy + z * ofz);
    const T osq = ofx * ofx + ofy * ofy + ofz * ofz;
    const T sft = (T(2) * pdo + osq) / (nw_norm + hD);
    const T dxn = (ofx - x * sft) / nw_norm;
    const T dyn = (ofy - y * sft) / nw_norm;
    const T dzn = (ofz - z * sft) / nw_norm;
    if (finite(dxn) && finite(dyn) && finite(dzn)) {
      ax = ax + dxn;
      ay = ay + dyn;
      az = az + dzn;
    }
  }
  o0[p] = o0[p] + ax;
  if (!kPaint) {
    o1[p] = o1[p] + ay;
    o2[p] = o2[p] + az;
  }
}

template <typename T>
int launch(int mode, const void* px, const void* py, const void* pz,
           const void* dense, const void* counts, const void* recs,
           const void* rows, void* o0, void* o1, void* o2, long long npix,
           long long F, int k_pad, int n_hi, double g0, double dg,
           double rad_hi, void* stream) {
  if (npix <= 0) return static_cast<int>(cudaSuccess);
  if (F <= 0 || k_pad <= 0 || n_hi < 2 || npix % F != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(px);
  const T* y = static_cast<const T*>(py);
  const T* z = static_cast<const T*>(pz);
  const int32_t* d = static_cast<const int32_t*>(dense);
  const int32_t* n = static_cast<const int32_t*>(counts);
  const T* rc = static_cast<const T*>(recs);
  const T* rw = static_cast<const T*>(rows);
  T* a = static_cast<T*>(o0);
  T* b = static_cast<T*>(o1);
  T* c = static_cast<T*>(o2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const T tg0 = static_cast<T>(g0), tdg = static_cast<T>(dg);
  const T thi = static_cast<T>(rad_hi);
  switch (mode) {
    case 0:    // offsets
      cellmajor_kernel<T, false, false><<<grid, kThreads, 0, s>>>(
          x, y, z, d, n, rc, rw, a, b, c, npix, F, k_pad, n_hi, tg0, tdg, thi);
      break;
    case 1:    // offsets, radial axis in units of R_com
      cellmajor_kernel<T, false, true><<<grid, kThreads, 0, s>>>(
          x, y, z, d, n, rc, rw, a, b, c, npix, F, k_pad, n_hi, tg0, tdg, thi);
      break;
    case 2:    // paint
      cellmajor_kernel<T, true, false><<<grid, kThreads, 0, s>>>(
          x, y, z, d, n, rc, rw, a, b, c, npix, F, k_pad, n_hi, tg0, tdg, thi);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers; in
// paint mode (2) o1 and o2 may be null. Returns cudaGetLastError() of the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int cellmajor_pass_f32(int mode, const void* px, const void* py,
                                  const void* pz, const void* dense,
                                  const void* counts, const void* recs,
                                  const void* rows, void* o0, void* o1,
                                  void* o2, long long npix, long long F,
                                  int k_pad, int n_hi, double g0, double dg,
                                  double rad_hi, void* stream) {
  return launch<float>(mode, px, py, pz, dense, counts, recs, rows, o0, o1,
                       o2, npix, F, k_pad, n_hi, g0, dg, rad_hi, stream);
}

extern "C" int cellmajor_pass_f64(int mode, const void* px, const void* py,
                                  const void* pz, const void* dense,
                                  const void* counts, const void* recs,
                                  const void* rows, void* o0, void* o1,
                                  void* o2, long long npix, long long F,
                                  int k_pad, int n_hi, double g0, double dg,
                                  double rad_hi, void* stream) {
  return launch<double>(mode, px, py, pz, dense, counts, recs, rows, o0, o1,
                        o2, npix, F, k_pad, n_hi, g0, dg, rad_hi, stream);
}
