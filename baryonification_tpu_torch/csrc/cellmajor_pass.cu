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
// (the angular test cos(angle) >= cos_reach, or r_com >= eps_max R_com),
// outside the row's radial range [g0, rad_hi], or where the value is not
// finite (rows of halos outside the table's grid are NaN). The sums are
// added once to the output planes.
//
// What bounds it: issued instructions, not bytes (each pixel's planes are
// read and written once; the records and rows are small and read from
// L1/L2). Most slot-pixels lie outside their disc: the registration lists
// a halo in every cell that its disc plus a margin of 1.15 cell
// resolutions can reach, and every pixel of a listed cell tests it. The
// first design paid for the whole disc test (a sqrt, an IEEE division and
// a log, built without fast math) before it could reject a slot. This
// design:
//
// 1. The cheap test first: the angular test (a dot product and a compare)
//    runs before the sqrt, division and log; the disc conditions are a
//    conjunction, so the order changes no result.
// 2. A patch-wide cull, done once a candidate and patch. Where F is a
//    multiple of 32, a warp is a patch: 32 consecutive pixels of one cell,
//    which walk the same candidates. Its lanes build a cap over their
//    pixel centres by butterfly shuffles (bitwise the same in every lane):
//    the centre c (the normalised sum), cos/sin of a radius rho, and dp,
//    the largest |p.p - 1| of its pixels. The candidates are then taken 32
//    at a time: lane j tests candidate k0 + j against the cap, a ballot
//    keeps those that survive, in slot order, and the warp walks only
//    those (their ids passed by a shuffle). The ids are loaded two chunks
//    ahead and the records' heads one chunk ahead, so the test waits on no
//    load. A test run for every slot by every lane would cost as much as
//    the lane's own angular test (measured: 5% slower than none); once a
//    candidate it costs a lane about one instruction, and a culled slot
//    costs nothing more. Cells smaller than a warp (F = 4, 16) walk their
//    slots without the cull.
//    The test (in the working dtype, eps its machine epsilon, u = eps/2):
//        dh = |h.h - 1|,  C = cos_reach - dp - dh - 16 eps  (> 0),
//        L  = C cos(rho) - sqrt((1 - C)(1 + C)) sin(rho),
//        cull if  c.h < L - dh - 16 eps,
//    with cos(rho) = min over the patch of c.p, less dp and 16 eps (> 0).
//    Why it is conservative against the kernel's own float test, for any
//    stored vectors: a pixel passes fl(p.h) >= cos_reach only if its exact
//    cosine p^.h^ >= cos_reach - (dp + dh)/2 - 7.1u > C (three-term dot
//    products err by <= 3.1u |p||h|; |p| <= 1 + dp/2 + 2u). cos(rho) lies
//    below every pixel's exact c^.p^, so rho~ = acos(cos(rho)) covers the
//    patch; L is within 8u of cos(acos(C) + rho~), and a culled slot has
//    c^.h^ <= fl(c.h) + dh/2 + 8u < cos(acos(C) + rho~): its halo lies
//    more than acos(C) from every pixel of the patch (both angles below
//    pi/2), so no pixel passes. Skipped slots add nothing and the others
//    keep their order, so the output is bit-identical to a run without the
//    cull (argument cull = 0). Where 1 - cos is a few ulps (small discs in
//    float32, or vectors rounded from float32 in float64) the margins widen
//    disc and cap and the cull does less.
// 3. Fewer loads and divisions: the record is ordered so that the lane
//    test reads one 16-byte load (two in float64) and the inside path one
//    more; the inside path multiplies by 1/dg and by one reciprocal of
//    nw_norm where it divided (the plain version does the same).
//
// One thread a pixel, the grid sized by the pixels, so F (4 to millions)
// sets no shape. Sums stay in registers; every pixel is written by its own
// thread once: no atomics, no sort. The arithmetic is the plain version's
// (ops/cellmajor_cuda.py), operation for operation; the source is built
// without FMA contraction (_cuda_build.py), so it rounds as the plain
// version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Eps;
template <>
struct Eps<float> { static constexpr float v = 1.1920928955078125e-07f; };
template <>
struct Eps<double> { static constexpr double v = 2.220446049250313e-16; };

template <typename T>
__device__ __forceinline__ bool finite(T x) { return isfinite(x); }

// A slot record (slot_records) is 8 values: vx vy vz cos_reach | D a eps_R
// lnR, two 16-byte rows in float32 (four in float64).
__device__ __forceinline__ void load_head(const float* recs, int h,
                                          float (&r)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(recs) + 2LL * h);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
}
__device__ __forceinline__ void load_tail(const float* recs, int h,
                                          float (&r)[4]) {
  const float4 a =
      __ldg(reinterpret_cast<const float4*>(recs) + 2LL * h + 1);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
}
__device__ __forceinline__ void load_head(const double* recs, int h,
                                          double (&r)[4]) {
  const double2* q = reinterpret_cast<const double2*>(recs) + 4LL * h;
  const double2 a = __ldg(q), b = __ldg(q + 1);
  r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
}
__device__ __forceinline__ void load_tail(const double* recs, int h,
                                          double (&r)[4]) {
  const double2* q = reinterpret_cast<const double2*>(recs) + 4LL * h + 2;
  const double2 a = __ldg(q), b = __ldg(q + 1);
  r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
}

// butterflies over the warp: every lane ends with the same bits
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// one slot: the contribution of halo h to pixel (x, y, z), if any
template <typename T, bool kPaint, bool kRdelta>
__device__ __forceinline__ void add_slot(int h, T x, T y, T z,
                                         const T* __restrict__ recs,
                                         const T* __restrict__ rows,
                                         int n_hi, T g0, T inv_dg, T rad_hi,
                                         T& ax, T& ay, T& az) {
  T hv[4];
  load_head(recs, h, hv);
  const T hvx = hv[0], hvy = hv[1], hvz = hv[2];
  const T cosang = x * hvx + y * hvy + z * hvz;
  if (!(cosang >= hv[3])) return;
  T tl[4];
  load_tail(recs, h, tl);
  const T hD = tl[0], ha = tl[1], hReps = tl[2];
  const T tiny = static_cast<T>(1e-30);
  const T dx = (x - hvx) * hD;
  const T dy = (y - hvy) * hD;
  const T dz = (z - hvz) * hD;
  const T r_sep = sqrt(dx * dx + dy * dy + dz * dz);
  T r_com, rad;
  if (kPaint) {
    r_com = fmax(r_sep / ha, tiny);
    rad = log(r_com);
  } else {
    r_com = r_sep / ha;
    rad = log(fmax(r_com, tiny));
    if (kRdelta) rad = rad - tl[3];
  }
  if (!(rad >= g0 && rad <= rad_hi && r_com < hReps)) return;
  // lerp between two nodes of the halo's row (t clipped to the row)
  const T t = (rad - g0) * inv_dg;
  const T tc = fmin(fmax(t, T(0)), static_cast<T>(n_hi - 1));
  int i = static_cast<int>(floor(tc));
  i = min(max(i, 0), n_hi - 2);
  const T w = tc - static_cast<T>(i);
  const T* row = rows + static_cast<long long>(h) * n_hi;
  const T v = (T(1) - w) * __ldg(row + i) + w * __ldg(row + i + 1);
  if (kPaint) {
    const T paint = exp(v);
    if (finite(paint)) ax = ax + paint;
    return;
  }
  if (!finite(v)) return;
  const T d = v * ha;                                    // physical
  const T scale = d / fmax(r_sep, tiny);
  const T ofx = scale * dx;
  const T ofy = scale * dy;
  const T ofz = scale * dz;
  const T nwx = x * hD + ofx;
  const T nwy = y * hD + ofy;
  const T nwz = z * hD + ofz;
  const T nw_norm = sqrt(nwx * nwx + nwy * nwy + nwz * nwz);
  const T pdo = hD * (x * ofx + y * ofy + z * ofz);
  const T osq = ofx * ofx + ofy * ofy + ofz * ofz;
  const T sft = (T(2) * pdo + osq) / (nw_norm + hD);
  const T inv_nw = T(1) / nw_norm;
  const T dxn = (ofx - x * sft) * inv_nw;
  const T dyn = (ofy - y * sft) * inv_nw;
  const T dzn = (ofz - z * sft) * inv_nw;
  if (finite(dxn) && finite(dyn) && finite(dzn)) {
    ax = ax + dxn;
    ay = ay + dyn;
    az = az + dzn;
  }
}

// kPatch: F is a multiple of 32 (the patch cull); the two loops are two
// kernels, so that each holds one copy of add_slot's registers
template <typename T, bool kPaint, bool kRdelta, bool kPatch>
__global__ void __launch_bounds__(kThreads)
cellmajor_kernel(const T* __restrict__ px, const T* __restrict__ py,
                 const T* __restrict__ pz, const int32_t* __restrict__ dense,
                 const int32_t* __restrict__ counts,
                 const T* __restrict__ recs, const T* __restrict__ rows,
                 T* __restrict__ o0, T* __restrict__ o1, T* __restrict__ o2,
                 long long npix, long long F, int k_pad, int n_hi, T g0,
                 T inv_dg, T rad_hi, int cull,
                 unsigned long long* __restrict__ kept) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= npix) return;
  const long long c = p / F;
  const int cnt = counts[c];
  if (cnt <= 0) return;
  const T x = px[p], y = py[p], z = pz[p];
  const int32_t* hids = dense + c * k_pad;
  T ax = 0, ay = 0, az = 0;
  if (!kPatch) {
    // cells smaller than a warp: every lane walks its cell's slots
    int h_next = __ldg(hids);
    for (int k = 0; k < cnt; ++k) {
      const int h = h_next;
      h_next = k + 1 < cnt ? __ldg(hids + k + 1) : 0;
      add_slot<T, kPaint, kRdelta>(h, x, y, z, recs, rows, n_hi, g0,
                                   inv_dg, rad_hi, ax, ay, az);
    }
  } else {
    // the warp is a patch of 32 pixels of one cell (32 | F | npix), so it
    // takes these exits and branches as one
    const int lane = threadIdx.x & 31;
    const unsigned all = 0xffffffffu;
    const T eps = Eps<T>::v;
    // the patch's cap: centre c, radius rho, and dp = max |p.p - 1|
    const T sx = warp_sum(x), sy = warp_sum(y), sz = warp_sum(z);
    const T sn = sqrt(sx * sx + sy * sy + sz * sz);
    const T cx = sx / sn, cy = sy / sn, cz = sz / sn;
    const T dp = warp_max(fabs((x * x + y * y + z * z) - T(1)));
    const T cosrho =
        (warp_min(cx * x + cy * y + cz * z) - dp) - T(16) * eps;
    const T sinrho = sqrt((T(1) - cosrho) * (T(1) + cosrho));
    const bool capped = cull != 0 && cosrho > T(0);
    // lane j tests candidate k0 + j for the whole patch; ids are loaded
    // two chunks ahead and the heads of their records one chunk ahead
    int id0 = lane < cnt ? __ldg(hids + lane) : 0;
    int id1 = 32 + lane < cnt ? __ldg(hids + 32 + lane) : 0;
    T hd[4] = {0, 0, 0, 0};
    if (capped && lane < cnt) load_head(recs, id0, hd);
    for (int k0 = 0; k0 < cnt; k0 += 32) {
      bool keep = k0 + lane < cnt;
      if (capped && keep) {
        const T dh = fabs((hd[0] * hd[0] + hd[1] * hd[1] + hd[2] * hd[2])
                          - T(1));
        const T cc = ((hd[3] - dp) - dh) - T(16) * eps;
        if (cc > T(0)) {
          const T sc = sqrt((T(1) - cc) * (T(1) + cc));
          const T lim = ((cc * cosrho - sc * sinrho) - dh) - T(16) * eps;
          keep = !(cx * hd[0] + cy * hd[1] + cz * hd[2] < lim);
        }
      }
      unsigned todo = __ballot_sync(all, keep);
      if (kept != nullptr && lane == 0)
        atomicAdd(kept, static_cast<unsigned long long>(__popc(todo)));
      const int hk = id0;
      id0 = id1;
      id1 = k0 + 64 + lane < cnt ? __ldg(hids + k0 + 64 + lane) : 0;
      if (capped && k0 + 32 + lane < cnt) load_head(recs, id0, hd);
      while (todo) {                    // the kept slots, in slot order
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int h = __shfl_sync(all, hk, src);
        add_slot<T, kPaint, kRdelta>(h, x, y, z, recs, rows, n_hi, g0,
                                     inv_dg, rad_hi, ax, ay, az);
      }
    }
  }
  o0[p] = o0[p] + ax;
  if (!kPaint) {
    o1[p] = o1[p] + ay;
    o2[p] = o2[p] + az;
  }
}

template <typename T, bool kPaint, bool kRdelta>
void launch_kernel(bool patch, unsigned grid, cudaStream_t s, const T* x,
                   const T* y, const T* z, const int32_t* d, const int32_t* n,
                   const T* rc, const T* rw, T* a, T* b, T* c,
                   long long npix, long long F, int k_pad, int n_hi, T g0,
                   T inv_dg, T rad_hi, int cull, unsigned long long* kp) {
  if (patch)
    cellmajor_kernel<T, kPaint, kRdelta, true><<<grid, kThreads, 0, s>>>(
        x, y, z, d, n, rc, rw, a, b, c, npix, F, k_pad, n_hi, g0, inv_dg,
        rad_hi, cull, kp);
  else
    cellmajor_kernel<T, kPaint, kRdelta, false><<<grid, kThreads, 0, s>>>(
        x, y, z, d, n, rc, rw, a, b, c, npix, F, k_pad, n_hi, g0, inv_dg,
        rad_hi, cull, kp);
}

template <typename T>
int launch(int mode, const void* px, const void* py, const void* pz,
           const void* dense, const void* counts, const void* recs,
           const void* rows, void* o0, void* o1, void* o2, long long npix,
           long long F, int k_pad, int n_hi, double g0, double dg,
           double rad_hi, int cull, void* kept, void* stream) {
  if (npix <= 0) return static_cast<int>(cudaSuccess);
  if (F <= 0 || k_pad <= 0 || n_hi < 2 || npix % F != 0 ||
      reinterpret_cast<uintptr_t>(recs) % 16 != 0)
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
  auto* kp = static_cast<unsigned long long*>(kept);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const T tg0 = static_cast<T>(g0), tinv = static_cast<T>(1.0 / dg);
  const T thi = static_cast<T>(rad_hi);
  const bool patch = F % 32 == 0;
  switch (mode) {
    case 0:    // offsets
      launch_kernel<T, false, false>(patch, grid, s, x, y, z, d, n, rc, rw,
                                     a, b, c, npix, F, k_pad, n_hi, tg0,
                                     tinv, thi, cull, kp);
      break;
    case 1:    // offsets, radial axis in units of R_com
      launch_kernel<T, false, true>(patch, grid, s, x, y, z, d, n, rc, rw,
                                    a, b, c, npix, F, k_pad, n_hi, tg0,
                                    tinv, thi, cull, kp);
      break;
    case 2:    // paint
      launch_kernel<T, true, false>(patch, grid, s, x, y, z, d, n, rc, rw,
                                    a, b, c, npix, F, k_pad, n_hi, tg0,
                                    tinv, thi, cull, kp);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// recs must be 16-byte aligned; in paint mode (2) o1 and o2 may be null;
// cull = 0 runs without the patch cull (the same result, bit for bit);
// kept, if not null, is one uint64 to which the launch adds the number of
// (patch, slot) pairs that its patches walk (F a multiple of 32).
// Returns cudaGetLastError() of the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int cellmajor_pass_f32(int mode, const void* px, const void* py,
                                  const void* pz, const void* dense,
                                  const void* counts, const void* recs,
                                  const void* rows, void* o0, void* o1,
                                  void* o2, long long npix, long long F,
                                  int k_pad, int n_hi, double g0, double dg,
                                  double rad_hi, int cull, void* kept,
                                  void* stream) {
  return launch<float>(mode, px, py, pz, dense, counts, recs, rows, o0, o1,
                       o2, npix, F, k_pad, n_hi, g0, dg, rad_hi, cull, kept,
                       stream);
}

extern "C" int cellmajor_pass_f64(int mode, const void* px, const void* py,
                                  const void* pz, const void* dense,
                                  const void* counts, const void* recs,
                                  const void* rows, void* o0, void* o1,
                                  void* o2, long long npix, long long F,
                                  int k_pad, int n_hi, double g0, double dg,
                                  double rad_hi, int cull, void* kept,
                                  void* stream) {
  return launch<double>(mode, px, py, pz, dense, counts, recs, rows, o0, o1,
                        o2, npix, F, k_pad, n_hi, g0, dg, rad_hi, cull, kept,
                        stream);
}
