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

// ---------------------------------------------------------------------------
// The adjoint (VJP) of the pass with respect to the halo rows, and its
// second-order entry.
//
// What they differentiate: the JAX package's cellmajor_offsets_pass and
// cellmajor_paint_pass (baryonification_tpu/runners/shell_cellmajor.py:255
// and :372), whose gradients are XLA autodiff of the same loop (jax.grad for
// the adjoint, jax.hessian for the second order); there is no TPU kernel.
// Here a slot that the forward adds reads v = (1 - w) row[i] + w row[i + 1]
// from its halo's row and adds f(v) to its pixel: the three components of
// the unit-vector delta (offsets modes) or exp(v) (paint). With g the
// cotangent of the output planes, the adjoint adds s = sum_c g_c[p] f_c'(v)
// times the lerp weights into the row's two nodes:
//     d_rows[h, i] += s (1 - w),   d_rows[h, i + 1] += s w.
// The second-order entry is the derivative of that VJP in the direction u
// of the rows' cotangent: with lu = (1 - w) u[h, i] + w u[h, i + 1] it
// writes the JVP planes j_c[p] = sum_slots f_c'(v) lu (the derivative with
// respect to g) and adds s2 = sum_c g_c[p] f_c''(v) lu times the lerp
// weights into d2_rows (the derivative with respect to the rows).
// Reverse-over-reverse autograd (torch.autograd.grad with create_graph)
// gives the exact Hessian through the pass with these two entries.
//
// The walk is the forward's, one thread a NESTED pixel: where F is a
// multiple of 32 a warp is a patch and tests each candidate once against
// the same conservative cap, walking the kept slots in slot order; a culled
// slot adds nothing to the forward, so nothing to its derivatives.
// slot_geometry repeats the forward's tests and lerp position operation for
// operation, so every entry takes the forward's slots with the same (i, w)
// (the offsets value's finite test is the forward's up to rounding, see
// offsets_vjp). Slots that the forward skips (outside the disc or the
// radial range, a value that is not finite, the NaN rows of halos outside
// the table's grid) add nothing here: no NaN reaches d_rows. The sums of
// the rows are taken with atomics in no fixed order, so gradients hold to
// tolerances, not bit for bit.
//
// What bounds it on this card, measured at shell-1e6's largest bucket
// (5.28e8 slot-pixels, 2.14e8 inside their disc; PERF.md): the inside
// slots' arithmetic and the registers it holds, not the walk's loads. The
// first design took 3.91 ms in float32 against the forward's 2.86 ms, and
// 3.84 ms with its two global atomics a slot inside (4.3e8 a launch) kept
// in registers: it carried the derivative through the contribution as a
// dual number (twice the forward's divisions and square roots, about twice
// its products and, in float64, 82 registers a thread against the
// forward's 80: two blocks a multiprocessor, not three). So:
// - The first-order offsets derivative is in closed form (offsets_vjp):
//   four scalars, a square root and three divisions, the forward's count
//   of operations; the float64 kernel fits the forward's 80 registers
//   (5.26 ms against the first design's 10.15 and the forward's 6.37).
// - Then the global atomics were a third of the float32 time (2.12 of
//   3.3 ms). In float32 the four lanes of each 2 x 2 block of pixels
//   first sum the terms that fall on one node, by two xor shuffles
//   (MergeLanes): 0.62 of the atomics, 2.98 ms, at 71% of its issue bound
//   (the shuffles run for every walked slot). Merging 8 or 32 lanes costs
//   more than it saves; float64 merges none (its atomics take 0.2 ms, and
//   the shuffles of doubles more).
// - Rows summed in shared memory (a strip of n_hi nodes a warp, one global
//   atomic a node) made 0.14 of the atomics but took 6.8 ms against the
//   dual form's 4.1: a float or double atomicAdd into shared memory is an
//   LDS / ATOMS.CAST.SPIN retry loop on sm_90a, serialised over the lanes
//   that meet at a node.
// - The walk loads the candidate ids and the records' heads inside the
//   chunk step. The forward's look-ahead loads (ids two chunks ahead,
//   heads one) keep seven to thirteen more registers live through the
//   slot's arithmetic and cost a block a multiprocessor: 0.15 ms slower in
//   float32, 1.4 ms in float64.
// experiments/cellmajor_adjoint/ keeps the strip and the look-ahead as
// patches, to measure them again.
// The second-order entry keeps the dual numbers, Dual<Dual<T>> carrying
// f, f' and f'' through one copy of the arithmetic: it runs on the small
// buckets of the fits, where it takes microseconds.
// ---------------------------------------------------------------------------

namespace {

template <typename S>
struct Dual {
  S v, d;
};

template <typename S>
__device__ __forceinline__ Dual<S> operator+(Dual<S> a, Dual<S> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(Dual<S> a, Dual<S> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator*(Dual<S> a, Dual<S> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator/(Dual<S> a, Dual<S> b) {
  const S q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
// a constant c of the base type: times, plus, and c - a
__device__ __forceinline__ float mulc(float a, float c) { return a * c; }
__device__ __forceinline__ double mulc(double a, double c) { return a * c; }
template <typename S, typename T>
__device__ __forceinline__ Dual<S> mulc(Dual<S> a, T c) {
  return {mulc(a.v, c), mulc(a.d, c)};
}
__device__ __forceinline__ float addc(float a, float c) { return a + c; }
__device__ __forceinline__ double addc(double a, double c) { return a + c; }
template <typename S, typename T>
__device__ __forceinline__ Dual<S> addc(Dual<S> a, T c) {
  return {addc(a.v, c), a.d};
}
__device__ __forceinline__ float dsqrt(float a) { return sqrt(a); }
__device__ __forceinline__ double dsqrt(double a) { return sqrt(a); }
template <typename S>
__device__ __forceinline__ Dual<S> dsqrt(Dual<S> a) {
  const S r = dsqrt(a.v);
  return {r, a.d / (r + r)};
}
template <typename S, typename T>
__device__ __forceinline__ S recip(S a, T one) {
  // 1 / a as the forward computes it (T(1) / nw_norm)
  return S{one} / a;
}

// a dual variable seeded at v, ((v, 1), (1, 0)), whose parts are then
// (f, f') and (f', f'')
template <typename T>
__device__ __forceinline__ Dual<Dual<T>> seed2(T v) {
  return {{v, T(1)}, {T(1), T(0)}};
}

// where a slot lands: the forward's tests and lerp position
template <typename T>
struct SlotGeom {
  T dx, dy, dz, r_sep, hD, ha, w;
  int i;
};

template <typename T, bool kPaint, bool kRdelta>
__device__ __forceinline__ bool slot_geometry(int h, T x, T y, T z,
                                              const T* __restrict__ recs,
                                              int n_hi, T g0, T inv_dg,
                                              T rad_hi, SlotGeom<T>& g) {
  T hv[4];
  load_head(recs, h, hv);
  const T hvx = hv[0], hvy = hv[1], hvz = hv[2];
  const T cosang = x * hvx + y * hvy + z * hvz;
  if (!(cosang >= hv[3])) return false;
  T tl[4];
  load_tail(recs, h, tl);
  const T hD = tl[0], ha = tl[1], hReps = tl[2];
  const T tiny = static_cast<T>(1e-30);
  g.dx = (x - hvx) * hD;
  g.dy = (y - hvy) * hD;
  g.dz = (z - hvz) * hD;
  g.r_sep = sqrt(g.dx * g.dx + g.dy * g.dy + g.dz * g.dz);
  T r_com, rad;
  if (kPaint) {
    r_com = fmax(g.r_sep / ha, tiny);
    rad = log(r_com);
  } else {
    r_com = g.r_sep / ha;
    rad = log(fmax(r_com, tiny));
    if (kRdelta) rad = rad - tl[3];
  }
  if (!(rad >= g0 && rad <= rad_hi && r_com < hReps)) return false;
  const T t = (rad - g0) * inv_dg;
  const T tc = fmin(fmax(t, T(0)), static_cast<T>(n_hi - 1));
  int i = static_cast<int>(floor(tc));
  g.i = min(max(i, 0), n_hi - 2);
  g.w = tc - static_cast<T>(g.i);
  g.hD = hD;
  g.ha = ha;
  return true;
}

// the offsets contribution f(v) = (dxn, dyn, dzn), the forward's
// arithmetic on the scalar S
template <typename S, typename T>
__device__ __forceinline__ void offsets_of(S v, T x, T y, T z,
                                           const SlotGeom<T>& g, S (&dn)[3]) {
  const T tiny = static_cast<T>(1e-30);
  const S d = mulc(v, g.ha);
  const S scale = d / S{fmax(g.r_sep, tiny)};
  const S ofx = mulc(scale, g.dx);
  const S ofy = mulc(scale, g.dy);
  const S ofz = mulc(scale, g.dz);
  const S nwx = addc(ofx, x * g.hD);
  const S nwy = addc(ofy, y * g.hD);
  const S nwz = addc(ofz, z * g.hD);
  const S nw_norm = dsqrt(nwx * nwx + nwy * nwy + nwz * nwz);
  const S pdo = mulc(mulc(ofx, x) + mulc(ofy, y) + mulc(ofz, z), g.hD);
  const S osq = ofx * ofx + ofy * ofy + ofz * ofz;
  const S sft = (mulc(pdo, T(2)) + osq) / addc(nw_norm, g.hD);
  const S inv_nw = recip(nw_norm, T(1));
  dn[0] = (ofx - mulc(sft, x)) * inv_nw;
  dn[1] = (ofy - mulc(sft, y)) * inv_nw;
  dn[2] = (ofz - mulc(sft, z)) * inv_nw;
}

template <typename T>
struct AdjointArgs {
  const T *px, *py, *pz;
  const int32_t *dense, *counts;
  const T *recs, *rows;
  const T *g0p, *g1p, *g2p;   // cotangent planes (one in paint mode)
  const T* u;                 // second order: the rows' direction (H, n_hi)
  T* d_rows;                  // (H, n_hi), added into with atomics
  T *j0, *j1, *j2;            // second order: the JVP planes, added into
  unsigned long long* tally;  // debug: {slot-pixels that add, global
                              // atomics made}, or null
  long long npix, F;
  int k_pad, n_hi;
  T g0, inv_dg, rad_hi;
};

// the rows' direction u read as the forward reads a row
template <typename T>
__device__ __forceinline__ T lerp_u(const T* u, T w) {
  return (T(1) - w) * __ldg(u) + w * __ldg(u + 1);
}

// The offsets contribution's derivative in v, contracted with the pixel's
// cotangent g (gp = g.p, pp = p.p): s = sum_c g_c dn_c'(v), in closed form.
// The forward's offset is of = v e with e = (ha / r_sep) (dx, dy, dz), so
// with pe = p.e, ee = e.e and ge = g.e (and hD the distance):
//   nw = p hD + v e,       |nw|^2 = hD^2 pp + t,  t = v (2 hD pe + v ee),
//   sft = t / (|nw| + hD), dn = (v e - p sft) / |nw|,
//   |nw|' = q / |nw| with q = nw.e = hD pe + v ee,
//   sft' = (2 q - sft |nw|') / (|nw| + hD),
//   g.dn' = (ge - gp sft' - (g.dn) |nw|') / |nw|.
// Four scalars carry it, with three reciprocals (one a square root's) and
// no vector held through the slot. The forward skips a slot whose delta is
// not finite, which, v and e being finite, is where 1 / |nw| or sft is
// not; the same test here (|nw| = 0 would put the pixel at the observer).
// Returns false where the forward skips the slot.
template <typename T>
__device__ __forceinline__ bool offsets_vjp(T v, T x, T y, T z,
                                            const SlotGeom<T>& g, T gx,
                                            T gy, T gz, T gp, T pp, T& s) {
  const T k = g.ha / fmax(g.r_sep, static_cast<T>(1e-30));
  const T ex = k * g.dx;
  const T ey = k * g.dy;
  const T ez = k * g.dz;
  const T pe = x * ex + y * ey + z * ez;
  const T ee = ex * ex + ey * ey + ez * ez;
  const T ge = gx * ex + gy * ey + gz * ez;
  const T q = g.hD * pe + v * ee;
  const T t = v * (q + g.hD * pe);
  const T nw2 = g.hD * g.hD * pp + t;
  const T nw = sqrt(nw2);
  const T inv_nw = T(1) / nw;
  const T rden = T(1) / (nw + g.hD);
  const T sft = t * rden;
  if (!(finite(inv_nw) && finite(sft))) return false;
  const T nn = q * inv_nw;
  const T sft_d = (T(2) * q - sft * nn) * rden;
  const T gdn = (v * ge - gp * sft) * inv_nw;
  s = inv_nw * ((ge - gp * sft_d) - gdn * nn);
  return true;
}

// one slot of entry kOrder (1: the adjoint, 2: the second-order entry):
// gx..gz are the pixel's cotangents (gp = g.p, pp = p.p), jx..jz its JVP
// sums. Returns whether the slot adds; then it adds its two terms to the
// rows (d_rows or d2_rows) or, with kDefer, leaves them to the caller: the
// node i and the terms a, b for nodes i and i + 1.
template <typename T, bool kPaint, bool kRdelta, int kOrder, bool kDefer>
__device__ __forceinline__ bool adjoint_slot(int h, T x, T y, T z,
                                             const AdjointArgs<T>& A, T gx,
                                             T gy, T gz, T gp, T pp, T& jx,
                                             T& jy, T& jz, int& i, T& a,
                                             T& b) {
  SlotGeom<T> g;
  if (!slot_geometry<T, kPaint, kRdelta>(h, x, y, z, A.recs, A.n_hi, A.g0,
                                         A.inv_dg, A.rad_hi, g))
    return false;
  const long long base = static_cast<long long>(h) * A.n_hi + g.i;
  const T* row = A.rows + base;
  const T v = (T(1) - g.w) * __ldg(row) + g.w * __ldg(row + 1);
  T s;
  if (kPaint) {
    const T p = exp(v);
    if (!finite(p)) return false;
    if (kOrder == 1) {
      s = gx * p;
    } else {
      const T lu = lerp_u(A.u + base, g.w);
      jx = jx + p * lu;
      s = gx * p * lu;
    }
  } else {
    if (!finite(v)) return false;
    if (kOrder == 1) {
      if (!offsets_vjp(v, x, y, z, g, gx, gy, gz, gp, pp, s)) return false;
    } else {
      Dual<Dual<T>> dn[3];
      offsets_of(seed2(v), x, y, z, g, dn);
      if (!(finite(dn[0].v.v) && finite(dn[1].v.v) && finite(dn[2].v.v)))
        return false;
      const T lu = lerp_u(A.u + base, g.w);
      jx = jx + dn[0].v.d * lu;
      jy = jy + dn[1].v.d * lu;
      jz = jz + dn[2].v.d * lu;
      s = (gx * dn[0].d.d + gy * dn[1].d.d + gz * dn[2].d.d) * lu;
    }
  }
  if (A.tally != nullptr) atomicAdd(A.tally, 1ULL);
  i = g.i;
  a = s * (T(1) - g.w);
  b = s * g.w;
  if (!kDefer) {
    atomicAdd(A.d_rows + base, a);
    atomicAdd(A.d_rows + base + 1, b);
    if (A.tally != nullptr) atomicAdd(A.tally + 1, 2ULL);
  }
  return true;
}

// Lanes of a group (aligned, 2 x 2 pixels for 4 in NESTED order) whose
// adds to one node a warp sums in registers before its global atomics:
// four in float32, where the atomics are a third of the kernel's time
// (2.1 of 3.3 ms without them) and two xor shuffles save more than they
// cost; none in float64, where the atomics take 0.2 of 5.2 ms and the
// shuffles of doubles cost more (PERF.md).
template <typename T>
struct MergeLanes;
template <>
struct MergeLanes<float> { static constexpr int v = 4; };
template <>
struct MergeLanes<double> { static constexpr int v = 1; };

// the forward's walk (and patch cull) over a pixel's candidates, calling
// adjoint_slot for each slot that the forward would walk
template <typename T, bool kPaint, bool kRdelta, bool kPatch, int kOrder>
__global__ void __launch_bounds__(kThreads)
adjoint_kernel(const AdjointArgs<T> A) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= A.npix) return;
  const long long c = p / A.F;
  const int cnt = A.counts[c];
  if (cnt <= 0) return;
  const T x = A.px[p], y = A.py[p], z = A.pz[p];
  const T gx = A.g0p[p];
  const T gy = kPaint ? T(0) : A.g1p[p];
  const T gz = kPaint ? T(0) : A.g2p[p];
  const T gp = gx * x + gy * y + gz * z;
  const T pp = x * x + y * y + z * z;
  const int32_t* hids = A.dense + c * A.k_pad;
  T jx = 0, jy = 0, jz = 0;
  if (!kPatch) {
    // cells smaller than a warp: every lane walks its cell's slots
    int i;
    T a, b;
    for (int k = 0; k < cnt; ++k)
      adjoint_slot<T, kPaint, kRdelta, kOrder, false>(
          __ldg(hids + k), x, y, z, A, gx, gy, gz, gp, pp, jx, jy, jz, i, a,
          b);
  } else {
    // the forward's patch cull (see cellmajor_kernel): the same cap and
    // test; the warp is a patch of 32 pixels of one cell, which takes these
    // exits and branches as one
    const int lane = threadIdx.x & 31;
    const unsigned all = 0xffffffffu;
    const T eps = Eps<T>::v;
    const T sx = warp_sum(x), sy = warp_sum(y), sz = warp_sum(z);
    const T sn = sqrt(sx * sx + sy * sy + sz * sz);
    const T cx = sx / sn, cy = sy / sn, cz = sz / sn;
    const T dp = warp_max(fabs((x * x + y * y + z * z) - T(1)));
    const T cosrho =
        (warp_min(cx * x + cy * y + cz * z) - dp) - T(16) * eps;
    const T sinrho = sqrt((T(1) - cosrho) * (T(1) + cosrho));
    const bool capped = cosrho > T(0);
    for (int k0 = 0; k0 < cnt; k0 += 32) {
      bool keep = k0 + lane < cnt;
      const int hk = keep ? __ldg(hids + k0 + lane) : 0;
      if (capped && keep) {
        T hd[4];
        load_head(A.recs, hk, hd);
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
      while (todo) {                    // the kept slots, in slot order
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int h = __shfl_sync(all, hk, src);
        constexpr int kMerge = MergeLanes<T>::v;
        int i = 0;
        T a = T(0), b = T(0);
        bool lead = adjoint_slot<T, kPaint, kRdelta, kOrder, (kMerge > 1)>(
            h, x, y, z, A, gx, gy, gz, gp, pp, jx, jy, jz, i, a, b);
        if (kMerge > 1) {
          // a lane that adds to its partner's node hands its terms on
#pragma unroll
          for (int off = 1; off < kMerge; off <<= 1) {
            const int pi = __shfl_xor_sync(all, i, off);
            const T pa = __shfl_xor_sync(all, a, off);
            const T pb = __shfl_xor_sync(all, b, off);
            const bool pl =
                __shfl_xor_sync(all, static_cast<int>(lead), off) != 0;
            const bool same = lead && pl && pi == i;
            const bool low = (lane & off) == 0;
            a = same && low ? a + pa : a;
            b = same && low ? b + pb : b;
            lead = lead && !(same && !low);
          }
          if (lead) {
            T* d = A.d_rows + static_cast<long long>(h) * A.n_hi + i;
            atomicAdd(d, a);
            atomicAdd(d + 1, b);
            if (A.tally != nullptr) atomicAdd(A.tally + 1, 2ULL);
          }
        }
      }
    }
  }
  if (kOrder == 2) {
    A.j0[p] = A.j0[p] + jx;
    if (!kPaint) {
      A.j1[p] = A.j1[p] + jy;
      A.j2[p] = A.j2[p] + jz;
    }
  }
}

template <typename T, bool kPaint, bool kRdelta, int kOrder>
void launch_adjoint_kernel(bool patch, unsigned grid, cudaStream_t s,
                           const AdjointArgs<T>& A) {
  if (patch)
    adjoint_kernel<T, kPaint, kRdelta, true, kOrder>
        <<<grid, kThreads, 0, s>>>(A);
  else
    adjoint_kernel<T, kPaint, kRdelta, false, kOrder>
        <<<grid, kThreads, 0, s>>>(A);
}

template <typename T, int kOrder>
int launch_adjoint(int mode, const void* px, const void* py, const void* pz,
                   const void* dense, const void* counts, const void* recs,
                   const void* rows, const void* g0p, const void* g1p,
                   const void* g2p, const void* u, void* d_rows, void* j0,
                   void* j1, void* j2, long long npix, long long F,
                   int k_pad, int n_hi, double g0, double dg, double rad_hi,
                   void* tally, void* stream) {
  if (npix <= 0) return static_cast<int>(cudaSuccess);
  if (F <= 0 || k_pad <= 0 || n_hi < 2 || npix % F != 0 ||
      reinterpret_cast<uintptr_t>(recs) % 16 != 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  AdjointArgs<T> A;
  A.px = static_cast<const T*>(px);
  A.py = static_cast<const T*>(py);
  A.pz = static_cast<const T*>(pz);
  A.dense = static_cast<const int32_t*>(dense);
  A.counts = static_cast<const int32_t*>(counts);
  A.recs = static_cast<const T*>(recs);
  A.rows = static_cast<const T*>(rows);
  A.g0p = static_cast<const T*>(g0p);
  A.g1p = static_cast<const T*>(g1p);
  A.g2p = static_cast<const T*>(g2p);
  A.u = static_cast<const T*>(u);
  A.d_rows = static_cast<T*>(d_rows);
  A.j0 = static_cast<T*>(j0);
  A.j1 = static_cast<T*>(j1);
  A.j2 = static_cast<T*>(j2);
  A.tally = static_cast<unsigned long long*>(tally);
  A.npix = npix;
  A.F = F;
  A.k_pad = k_pad;
  A.n_hi = n_hi;
  A.g0 = static_cast<T>(g0);
  A.inv_dg = static_cast<T>(1.0 / dg);
  A.rad_hi = static_cast<T>(rad_hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const bool patch = F % 32 == 0;
  if (mode == 0)
    launch_adjoint_kernel<T, false, false, kOrder>(patch, grid, s, A);
  else if (mode == 1)
    launch_adjoint_kernel<T, false, true, kOrder>(patch, grid, s, A);
  else
    launch_adjoint_kernel<T, true, false, kOrder>(patch, grid, s, A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The adjoint: d_rows (H x n_hi, zeroed by the caller) += the VJP of the
// pass with cotangent planes g0p..g2p (g1p, g2p null in paint mode); tally:
// null, or two uint64 to which the launch adds the number of slot-pixels
// that add to the rows and the number of global atomics it makes. Returns
// cudaGetLastError() of the launch; asynchronous on `stream`.
#define CELLMAJOR_VJP(NAME, T)                                              \
  extern "C" int NAME(int mode, const void* px, const void* py,            \
                      const void* pz, const void* dense, const void* counts, \
                      const void* recs, const void* rows, const void* g0p,  \
                      const void* g1p, const void* g2p, void* d_rows,       \
                      long long npix, long long F, int k_pad, int n_hi,     \
                      double g0, double dg, double rad_hi, void* tally,     \
                      void* stream) {                                       \
    return launch_adjoint<T, 1>(mode, px, py, pz, dense, counts, recs,      \
                                rows, g0p, g1p, g2p, nullptr, d_rows,       \
                                nullptr, nullptr, nullptr, npix, F, k_pad,  \
                                n_hi, g0, dg, rad_hi, tally, stream);       \
  }
CELLMAJOR_VJP(cellmajor_vjp_f32, float)
CELLMAJOR_VJP(cellmajor_vjp_f64, double)

// The second-order entry: with u (H x n_hi) the direction of the rows'
// cotangent, j0p..j2p (zeroed by the caller; j1p, j2p null in paint mode)
// += sum_slots f'(v) lerp(u), and d2_rows (zeroed) += the lerp weights
// times sum_c g_c f_c''(v) lerp(u); tally as above.
#define CELLMAJOR_VJP2(NAME, T)                                             \
  extern "C" int NAME(int mode, const void* px, const void* py,            \
                      const void* pz, const void* dense, const void* counts, \
                      const void* recs, const void* rows, const void* g0p,  \
                      const void* g1p, const void* g2p, const void* u,      \
                      void* d2_rows, void* j0p, void* j1p, void* j2p,       \
                      long long npix, long long F, int k_pad, int n_hi,     \
                      double g0, double dg, double rad_hi, void* tally,     \
                      void* stream) {                                       \
    return launch_adjoint<T, 2>(mode, px, py, pz, dense, counts, recs,      \
                                rows, g0p, g1p, g2p, u, d2_rows, j0p, j1p,  \
                                j2p, npix, F, k_pad, n_hi, g0, dg, rad_hi,  \
                                tally, stream);                             \
  }
CELLMAJOR_VJP2(cellmajor_vjp2_f32, float)
CELLMAJOR_VJP2(cellmajor_vjp2_f64, double)
