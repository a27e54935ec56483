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
//   r_c  = sqrt((dx_0^2 + dx_1^2) [+ dx_2^2]); in 3D r = r_c, in 2D
//          r = |Rm dx| = sqrt(ex^2 + ey^2), ex = Rm0 dx_0 + Rm2 dx_1,
//          ey = Rm1 dx_0 + Rm3 dx_1 (the shear to the elliptical frame)
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
// What bounds it on this card: issued instructions and their latency,
// not bytes. Each voxel's planes are written once and the lists, records
// and rows are small and read from L1/L2; every listed voxel-slot is
// tested (grid-256's largest bucket lists 2.8e8, a third inside). The
// first design (one thread a voxel, every test per voxel-slot) spent most
// of its issue slots on work that does not depend on the voxel: the place
// u_d, the offset dx_d and the window bit take one of B values per (slot,
// axis), shared by B^(dim-1) voxels, yet were rebuilt per voxel-slot in
// 64-bit integers from records that every voxel loaded again; and a warp,
// whose lanes walk the same slot, paid for the square root, log and
// divisions whenever one lane was inside. This design:
//
// 1. The warp is the unit. A patch is the voxels of one block that one
//    warp holds: the whole block where it has at most 32 (padded to a
//    power of two L, 32 / L blocks a warp: 2D B = 4 gives two); a tile of
//    4 x 8 (2D) or 1 x 4 x 8 (3D) voxels where B is a multiple of 8, so
//    that a patch spans 12 or 13 offsets over its axes, not up to 34;
//    else 32 consecutive voxels (padding lanes, f >= F, do no voxel). Per
//    axis the patch's offsets lie in a range of n_d consecutive offsets
//    (the whole axis where its span wraps a block edge).
// 2. Per-axis terms staged once. The warp takes its slots S at a time
//    (S = 32 / patches a warp, fewer where shared memory is short): lane
//    l holds (patch l / S, slot l % S), loads its id (before the count is
//    known: lists are padded), window start and per-halo columns once,
//    and writes the slot's terms for every offset of the patch's ranges to
//    a row of the warp's shared memory: q = dx*dx (3D) or Rm dx's two
//    terms (2D), NaN outside the window, which fails r < reach as the
//    window test would; the offsets modes stage dx in a plane of its own,
//    read only by live voxel-slots, and rdelta each row's ln R_com. Each
//    term rounds as the plain version's (--fmad=false, _cuda_build.py). A
//    voxel-slot then reads dim terms and builds sq or ex, ey with the plain
//    version's adds in its order. The row stride is odd, so the lanes'
//    stores to their rows spread over the banks.
// 3. A conservative cull, once a (patch, slot), by the lane that staged
//    it: while writing the terms it keeps, over the offsets inside the
//    window, the least dx*dx (3D) or the least and largest of each Rm dx
//    term (2D). The slot is skipped for the patch where no offset of some
//    axis is inside the window, or where
//        rmin = sqrt((q_0 + q_1) + q_2)  (3D, q_d the least dx_d*dx_d), or
//        rmin = sqrt(ax*ax + ay*ay)      (2D, ax the least |ex| over the
//               interval [lo_a0 + lo_a1, hi_a0 + hi_a1] of ex, ay alike)
//    is >= reach, or where log(max(rmin, 1e-30)) [- ln R_com] exceeds
//    rad_hi by 16 eps (1 + |log| + |rad_hi| + |ln R_com|). Why it is
//    conservative, bit for bit: rounding to nearest is monotone, so each
//    voxel of the patch inside the window has fl(q_0 + q_1) + q_2 >= the
//    same sum of the least terms, |ex| >= ax, and so its r >= rmin (sqrt is
//    IEEE); r < reach then fails exactly. The log has an error of at most
//    1 ulp on this card, so log(r) >= log(rmin) - 3 eps (|log| + 1), and
//    the margin leaves the voxel's rad above rad_hi after the subtraction
//    of ln R_com rounds. A culled slot adds nothing and the others are
//    walked in the same order, so the planes are bit-identical to a run
//    without the cull (argument cull = 0), and so are the tallies' slots
//    and inside.
// 4. The cheap exact tests first: live is a conjunction, so r < reach runs
//    right after the square root and before the log; a warp whose lanes
//    all fail skips the log, the division and the read.
// 5. Each voxel sums its slots in slot order in registers and is written
//    once (grid_pass): no atomics, no sort, so a launch is deterministic.
// 6. grid_vjp's adds are merged: after each walked slot the lanes whose
//    shares land on the same node pair of the same halo (__match_any_sync
//    on the first node) sum them in a tree of shuffles, and the lowest of
//    them adds the sums with two red.global.add.
// 7. The launch bounds ask for 4 CTAs an SM in float32 and 3 in float64
//    (64 and 80 registers a thread; MinCtas): the walk waits on its row
//    reads and its long division and log chains, so warps in flight count
//    for more than registers, up to where an instance would spill.
// Measured on an H100 (PERF.md): staging and the cull alone take about
// 0.5 of grid-256's 1.3 ms at its largest bucket (float32), mostly the
// wait on each stage's dependent loads; a walk of two slots at a time and
// a prefetch of the next stage's ids were slower or no faster.
//
// Both entries take an optional tally: voxel-slots listed, voxel-slots
// inside (live), the adjoint's global atomic adds issued, and the
// (patch, slot) pairs culled; summed a CTA at a time and added with one
// atomic a count. The shape of a launch (L, patches a warp, S, the row
// stride, warps a CTA and the shared memory) is grid_launch_shape's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a warp may take for its staged rows before S is cut
constexpr long long kWarpBytes = 6144;
constexpr int kTally = 4;
// the tally's static shared memory (add_tally), which counts toward a
// CTA's limits beside the dynamic rows
constexpr long long kStaticSmem = kTally * kWarps * 8;
// the dynamic shared memory a CTA can take on sm_90, and without an opt-in
constexpr long long kMaxSmem = 227 * 1024 - kStaticSmem;
constexpr long long kDefaultSmem = 48 * 1024 - kStaticSmem;

template <typename T>
struct Eps;
template <>
struct Eps<float> { static constexpr float v = 1.1920928955078125e-07f; };
template <>
struct Eps<double> { static constexpr double v = 2.220446049250313e-16; };

template <typename T>
__device__ __forceinline__ T qnan();
template <>
__device__ __forceinline__ float qnan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}
template <typename T>
__device__ __forceinline__ T inf();
template <>
__device__ __forceinline__ float inf<float>() {
  return __int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ double inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// The staged per-axis term of a (patch, slot) that every voxel-slot
// reads: 3D q = dx*dx, 2D ea, eb = the axis's two terms of Rm dx; NaN
// outside the window. The offsets modes stage dx beside it, in a plane of
// its own that only live voxel-slots read.
template <typename T, int DIM>
struct Ent;
template <typename T>
struct Ent<T, 3> { T q; };
template <typename T>
struct alignas(2 * sizeof(T)) Ent<T, 2> { T ea, eb; };

// CTAs an SM that the launch bounds ask registers for (item 7 above): at
// most 64 registers a thread in float32, 80 in float64, 128 for the
// float64 rdelta adjoint, which spills at 80
template <typename T, int kMode, bool kVjp>
struct MinCtas {
  static constexpr int v =
      sizeof(T) == 4 ? 4 : (kMode == 1 && kVjp ? 2 : 3);
};

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
  int L, G, S, Es, tiled;   // the launch shape (launch_shape)
  int warp_bytes;           // a warp's shared memory
  int cull;
  T res, g0, dg, rad_hi;
  unsigned long long* tally;  // null, or {slots, inside, atomics, culled}
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

// the block's coordinate on axis d
template <int DIM>
__device__ __forceinline__ long long block_coord(long long b, int d) {
  const unsigned long long u = static_cast<unsigned long long>(b);
  return DIM == 3 ? compact3(u >> d) : compact2(u >> d);
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

// true where every voxel of a patch whose radius is >= rmin reads its rad
// above rad_hi: log(max(rmin, 1e-30)) [- lnR] beyond rad_hi by a margin
// that covers the log's 1 ulp and the rounding of the subtraction
template <typename T, bool kRdelta>
__device__ __forceinline__ bool beyond_row(T rmin, T lnR,
                                           const PassArgs<T>& A) {
  const T lg = log(fmax(rmin, static_cast<T>(1e-30)));
  const T shift = kRdelta ? lnR : T(0);
  const T m = T(16) * Eps<T>::v *
              (T(1) + fabs(lg) + fabs(A.rad_hi) + fabs(shift));
  return lg > (A.rad_hi + shift) + m;
}

// the sum of the peers' a and b into the lowest peer: a tree of shuffles
// over the lanes of ``peers`` (every lane of the warp calls it)
template <typename T>
__device__ __forceinline__ void reduce_peers(unsigned peers, T& a, T& b) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest);
    const T ta = __shfl_sync(kFull, a, (next - 1) & 31);
    const T tb = __shfl_sync(kFull, b, (next - 1) & 31);
    if (next) {
      a = a + ta;
      b = b + tb;
    }
    rest &= __ballot_sync(kFull, !(rel & 1));
    rel >>= 1;
  }
}

// the tally's counts of a CTA (a lane's own below 2^31), added with one
// atomic a count
__device__ __forceinline__ void add_tally(unsigned long long* tally,
                                          const unsigned (&lane_n)[kTally]) {
  __shared__ unsigned long long part[kTally][kWarps];
  unsigned long long n[kTally];
#pragma unroll
  for (int j = 0; j < kTally; ++j) {
    n[j] = lane_n[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      n[j] += __shfl_down_sync(kFull, n[j], off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < kTally; ++j) part[j][warp] = n[j];
  __syncthreads();
  if (threadIdx.x < kTally) {
    unsigned long long s = 0;
    for (int j = 0; j < static_cast<int>(blockDim.x >> 5); ++j)
      s += part[threadIdx.x][j];
    if (s != 0) atomicAdd(tally + threadIdx.x, s);
  }
}

// One warp a group of patches (see the header): the pass (kVjp false)
// sums each voxel's live slots in registers and writes each plane once;
// the adjoint (kVjp true) reads its cotangents and adds each live finite
// slot's two node shares to d_rows (out[0]), merged over the warp.
template <typename T, int DIM, int kMode, bool kVjp>
__global__ void __launch_bounds__(kThreads, MinCtas<T, kMode, kVjp>::v)
grid_kernel(PassArgs<T> A) {
  constexpr bool kPaint = kMode == 2, kRdelta = kMode == 1;
  constexpr int kPlanes = kPaint ? 1 : DIM;
  using E = Ent<T, DIM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int B = A.B, L = A.L, G = A.G, S = A.S, R = A.G * A.S;
  const int F = DIM == 3 ? B * B * B : B * B;
  // the warp's rows: R rows of Es terms, then (offsets) R rows of Es dx,
  // then (rdelta) each row's ln R_com
  E* ent = reinterpret_cast<E*>(smem + (threadIdx.x >> 5) * A.warp_bytes);
  T* dxe = reinterpret_cast<T*>(ent + R * A.Es);
  T* lnr_s = dxe + R * A.Es;
  const long long warp =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  // the warp's first block, and its patch m of the block where L > 32
  long long c0;
  int m = 0;
  if (L <= 32) {
    c0 = warp * G;
  } else {
    const int wpb = L / 32;
    c0 = warp / wpb;
    m = static_cast<int>(warp % wpb);
  }
  unsigned n[kTally] = {0, 0, 0, 0};  // slots inside atomics culled
  if (c0 < A.ncell) {
    // this lane's voxel f of block c; per axis the patches' offsets o0[d]
    // .. o0[d] + nax[d] - 1, and the column x[d] of the voxel's term in a
    // staged row
    const int g = L <= 32 ? lane / L : 0;
    int f = 0, o0[DIM], nax[DIM], x[DIM];
    {
      int st[DIM], stride = 1, off = 0;
#pragma unroll
      for (int d = DIM - 1; d >= 0; --d) {
        st[d] = stride;
        stride *= B;
      }
      if (A.tiled) {
        // patch m is a tile of 4 x 8 voxels (2D) or 1 x 4 x 8 (3D), the
        // tiles row-major in the block; the lane is (.., lane / 8, lane % 8)
        // of it
        int tl[DIM], lc[DIM];
        tl[DIM - 1] = 8;
        tl[DIM - 2] = 4;
        lc[DIM - 1] = lane % 8;
        lc[DIM - 2] = lane / 8;
        if (DIM == 3) tl[0] = 1, lc[0] = 0;
        int mm = m;
#pragma unroll
        for (int d = DIM - 1; d >= 0; --d) {
          const int nt = B / tl[d];
          o0[d] = (mm % nt) * tl[d];
          nax[d] = tl[d];
          mm /= nt;
        }
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          x[d] = off + lc[d];
          off += nax[d];
          f += (o0[d] + lc[d]) * st[d];
        }
      } else {
        // 32 consecutive voxels [fa, fb] of the block, or whole blocks
        const int fa = L <= 32 ? 0 : m * 32;
        const int fb = L <= 32 ? F - 1 : min(fa + 31, F - 1);
        f = L <= 32 ? lane % L : fa + lane;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const int q0 = fa / st[d], q1 = fb / st[d];
          if (q1 - q0 + 1 >= B || q0 / B != q1 / B) {
            o0[d] = 0;
            nax[d] = B;
          } else {
            o0[d] = q0 % B;
            nax[d] = q1 - q0 + 1;
          }
          x[d] = off + (f / st[d]) % B - o0[d];
          off += nax[d];
        }
      }
      if (off > A.Es) __trap();
    }
    const long long c = c0 + g;
    const bool active = c < A.ncell && f < F;
    // this lane's record: (patch gr, slot sr of each group of S slots)
    const int gr = lane / S, sr = lane - gr * S;
    const long long cr = c0 + gr;
    const bool rec_ok = lane < R && cr < A.ncell;
    const long long* ids = A.dense + cr * A.k_pad;
    const int cnt_r = rec_ok ? static_cast<int>(__ldg(A.counts + cr)) : 0;
    if (active) n[0] = static_cast<unsigned>(__ldg(A.counts + c));
    int kmax = cnt_r;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      kmax = max(kmax, __shfl_xor_sync(kFull, kmax, off));
    // the pass's sums, or the adjoint's cotangents
    T acc[kPlanes];
#pragma unroll
    for (int j = 0; j < kPlanes; ++j)
      acc[j] = kVjp && active ? __ldg(A.ct[j] + c * F + f) : T(0);
    const unsigned slot_bits = S >= 32 ? kFull : (1u << S) - 1u;
    for (int k0 = 0; k0 < kmax; k0 += S) {
      // stage: lane l writes row l, the terms of its (patch, slot)
      bool keep = false;
      int h = 0;
      T reach = T(0), lnR = T(0);
      const int k = k0 + sr;
      // the id is read before the count is known: lists are padded to
      // k_pad, and a slot past the count is not staged
      if (rec_ok && k < A.k_pad) h = static_cast<int>(__ldg(ids + k));
      if (rec_ok && k < cnt_r) {
        // the slot's columns, loaded together
        const T* rec = A.hrec + static_cast<long long>(h) * A.hcols;
        const long long* lop = A.lo + static_cast<long long>(h) * DIM;
        long long lo[DIM];
        T rd[DIM], rm[4];
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          lo[d] = __ldg(lop + d);
          rd[d] = __ldg(rec + d);
        }
        reach = __ldg(rec + DIM);
        if (kRdelta) {
          lnR = __ldg(rec + DIM + 1);
          lnr_s[lane] = lnR;
        }
        if constexpr (DIM == 2) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rm[j] = __ldg(rec + DIM + 1 + (kRdelta ? 1 : 0) + j);
        }
        E* row = ent + lane * A.Es;
        T* drow = dxe + lane * A.Es;
        const int two_half = 2 * A.half;
        bool win_all = true;
        T q_lo[DIM], a_lo[DIM], a_hi[DIM], b_lo[DIM], b_hi[DIM];
        int xo = 0;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          // the place of the patch's first offset on axis d in the window
          const long long iv0 =
              block_coord<DIM>(A.block0 + cr, d) * B + o0[d];
          int u = static_cast<int>(wrap(iv0 - lo[d], A.N));
          T ca = T(0), cb = T(0);
          if constexpr (DIM == 2) {
            ca = rm[d == 0 ? 0 : 2];
            cb = rm[d == 0 ? 1 : 3];
          }
          bool any = false;
          q_lo[d] = inf<T>();
          a_lo[d] = b_lo[d] = inf<T>();
          a_hi[d] = b_hi[d] = -inf<T>();
          for (int j = 0; j < nax[d]; ++j) {
            const bool w = u < two_half;
            const T dx = static_cast<T>(u - A.half) * A.res - rd[d];
            E e;
            if constexpr (!kPaint) drow[xo + j] = dx;
            if constexpr (DIM == 3) {
              const T q = dx * dx;
              e.q = w ? q : qnan<T>();
              if (w) q_lo[d] = fmin(q_lo[d], q);
            } else {
              const T ea = ca * dx, eb = cb * dx;
              e.ea = w ? ea : qnan<T>();
              e.eb = w ? eb : qnan<T>();
              if (w) {
                a_lo[d] = fmin(a_lo[d], ea);
                a_hi[d] = fmax(a_hi[d], ea);
                b_lo[d] = fmin(b_lo[d], eb);
                b_hi[d] = fmax(b_hi[d], eb);
              }
            }
            any = any || w;
            row[xo + j] = e;
            u = u + 1 == A.N ? 0 : u + 1;
          }
          xo += nax[d];
          win_all = win_all && any;
        }
        keep = true;
        if (A.cull) {
          bool cut = !win_all;
          if (!cut) {
            T rmin;
            if constexpr (DIM == 3) {
              rmin = sqrt((q_lo[0] + q_lo[1]) + q_lo[2]);
            } else {
              const T xl = a_lo[0] + a_lo[1], xh = a_hi[0] + a_hi[1];
              const T yl = b_lo[0] + b_lo[1], yh = b_hi[0] + b_hi[1];
              const T ax = xl > T(0) ? xl : (xh < T(0) ? -xh : T(0));
              const T ay = yl > T(0) ? yl : (yh < T(0) ? -yh : T(0));
              rmin = sqrt(ax * ax + ay * ay);
            }
            cut = rmin >= reach || beyond_row<T, kRdelta>(rmin, lnR, A);
          }
          keep = !cut;
          n[3] += cut;
        }
      }
      __syncwarp();
      const unsigned kept = __ballot_sync(kFull, keep);
      unsigned smask = 0;
      for (int gg = 0; gg < G; ++gg) smask |= (kept >> (gg * S)) & slot_bits;
      // walk: each lane its voxel's kept slots, in slot order
      while (smask != 0) {
        const int s = __ffs(smask) - 1;
        smask &= smask - 1u;
        const int rg = g * S + s;
        const T rreach = __shfl_sync(kFull, reach, rg);
        const T rlnR = kRdelta ? lnr_s[rg] : T(0);
        const int rh = __shfl_sync(kFull, h, rg);
        long long base = -1;
        T sh0 = T(0), sh1 = T(0);
        if (active && ((kept >> rg) & 1u)) {
          const E* row = ent + rg * A.Es;
          E e[DIM];
#pragma unroll
          for (int d = 0; d < DIM; ++d) e[d] = row[x[d]];
          const T* drow = dxe + rg * A.Es;
          T r, r_c = T(0);
          if constexpr (DIM == 3) {
            r = sqrt((e[0].q + e[1].q) + e[2].q);
            r_c = r;
          } else {
            const T ex = e[0].ea + e[1].ea, ey = e[0].eb + e[1].eb;
            r = sqrt(ex * ex + ey * ey);
          }
          // the cheap exact test first (NaN outside the window fails it)
          if (r < rreach) {
            T rad = log(fmax(r, static_cast<T>(1e-30)));
            if (kRdelta) rad = rad - rlnR;
            if (rad >= A.g0 && rad <= A.rad_hi) {
              ++n[1];
              const T t = (rad - A.g0) / A.dg;
              const T i = fmin(fmax(floor(t), T(0)),
                               static_cast<T>(A.n_hi - 2));
              const T w = t - i;
              const long long b0 = static_cast<long long>(rh) * A.n_hi +
                                   static_cast<long long>(i);
              const T v = lerp(__ldg(A.rows + b0), __ldg(A.rows + b0 + 1),
                               w);
              T dxs[kPlanes];
              if constexpr (!kPaint) {
#pragma unroll
                for (int d = 0; d < DIM; ++d) dxs[d] = drow[x[d]];
                if constexpr (DIM == 2)
                  r_c = sqrt(dxs[0] * dxs[0] + dxs[1] * dxs[1]);
              }
              if constexpr (kVjp) {
                bool fin;
                T gv;
                if constexpr (kPaint) {
                  const T ev = exp(v);
                  fin = isfinite(ev);
                  gv = acc[0] * ev;
                } else {
                  fin = isfinite(v);
                  T gs = acc[0] * dxs[0];
#pragma unroll
                  for (int j = 1; j < kPlanes; ++j) gs = gs + acc[j] * dxs[j];
                  gv = (gs / fmax(r_c, static_cast<T>(1e-30))) / A.res;
                }
                if (fin) {
                  base = b0;
                  sh0 = gv * (T(1) - w);
                  sh1 = gv * w;
                }
              } else if constexpr (kPaint) {
                const T ev = exp(v);
                if (isfinite(ev)) acc[0] = acc[0] + ev;
              } else if (isfinite(v)) {
                const T scale =
                    (v / A.res) / fmax(r_c, static_cast<T>(1e-30));
#pragma unroll
                for (int j = 0; j < kPlanes; ++j)
                  acc[j] = acc[j] + scale * dxs[j];
              }
            }
          }
        }
        if constexpr (kVjp) {
          // lanes whose shares land on the same nodes add them once
          if (__any_sync(kFull, base >= 0)) {
            const unsigned peers = __match_any_sync(
                kFull, static_cast<unsigned long long>(base));
            reduce_peers(peers, sh0, sh1);
            if (base >= 0 && lane == __ffs(peers) - 1) {
              atomicAdd(A.out[0] + base, sh0);
              atomicAdd(A.out[0] + base + 1, sh1);
              n[2] += 2;
            }
          }
        }
      }
      __syncwarp();
    }
    if constexpr (!kVjp) {
      if (active) {
#pragma unroll
        for (int j = 0; j < kPlanes; ++j) A.out[j][c * F + f] = acc[j];
      }
    }
  }
  if (A.tally != nullptr) add_tally(A.tally, n);
}

// The launch's shape for B^dim voxels a block: L (F padded: the next power
// of two up to 32, else a multiple of 32), G patches (blocks) a warp where
// L <= 32, the most terms E of a patch's staged row (the sum over axes of
// its offset ranges, the widest over a block's warps), the odd row stride
// Es >= E, S slots a stage (G S <= 32 rows a warp, cut to kWarpBytes of
// shared memory where the rows are long), W warps a CTA (8, fewer where
// 8 warps' rows would not fit in a CTA's shared memory) and the CTA's
// shared bytes.
struct Shape {
  int L, G, S, E, Es, W, tiled;
  long long warp_bytes, smem;
};

Shape launch_shape(int dim, int B, long long ent_bytes, long long row_extra) {
  Shape s;
  const long long F = dim == 3 ? 1LL * B * B * B : 1LL * B * B;
  if (F <= 32) {
    s.L = 1;
    while (s.L < F) s.L *= 2;
    s.G = 32 / s.L;
  } else {
    s.L = static_cast<int>((F + 31) / 32 * 32);
    s.G = 1;
  }
  long long st[3], stride = 1;
  for (int d = dim - 1; d >= 0; --d) {
    st[d] = stride;
    stride *= B;
  }
  // where B is a multiple of 8, a warp of a block of more than 32 voxels
  // takes a tile (4 x 8, or 1 x 4 x 8): 12 or 13 terms; otherwise the
  // widest of its warps' ranges
  s.tiled = F > 32 && B % 8 == 0;
  s.E = s.tiled ? (dim == 3 ? 1 + 4 + 8 : 4 + 8) : 0;
  const int wpb = s.tiled ? 0 : (s.L <= 32 ? 1 : s.L / 32);
  for (int m = 0; m < wpb; ++m) {
    const long long fa = s.L <= 32 ? 0 : 32LL * m;
    const long long fb = s.L <= 32 ? F - 1 : std::min(fa + 31, F - 1);
    int e = 0;
    for (int d = 0; d < dim; ++d) {
      const long long q0 = fa / st[d], q1 = fb / st[d];
      e += (q1 - q0 + 1 >= B || q0 / B != q1 / B)
               ? B : static_cast<int>(q1 - q0 + 1);
    }
    s.E = std::max(s.E, e);
  }
  s.Es = s.E | 1;
  const long long per_row = s.Es * ent_bytes + row_extra;
  s.S = static_cast<int>(std::max(1LL, std::min<long long>(
      32 / s.G, kWarpBytes / (s.G * per_row))));
  const long long per_warp =
      (static_cast<long long>(s.G) * s.S * per_row + 15) / 16 * 16;
  s.warp_bytes = per_warp;
  s.W = static_cast<int>(std::max(1LL, std::min<long long>(
      kWarps, kMaxSmem / per_warp)));
  s.smem = s.W * per_warp;
  return s;
}

// the bytes of a staged term: the voxel-slots' term, and dx (offsets)
template <typename T>
long long ent_bytes(int dim, bool paint) {
  return (dim == 3 ? sizeof(Ent<T, 3>) : sizeof(Ent<T, 2>)) +
         (paint ? 0 : sizeof(T));
}

template <typename T, int DIM, int kMode, bool kVjp>
cudaError_t launch_one(unsigned grid, int warps, long long smem,
                       cudaStream_t s, const PassArgs<T>& A) {
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        grid_kernel<T, DIM, kMode, kVjp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  grid_kernel<T, DIM, kMode, kVjp>
      <<<grid, 32 * warps, static_cast<size_t>(smem), s>>>(A);
  return cudaGetLastError();
}

template <typename T, int DIM>
cudaError_t launch_dim(int mode, bool vjp, unsigned grid, int warps,
                       long long smem, cudaStream_t s, const PassArgs<T>& A) {
  if (mode == 0)
    return vjp ? launch_one<T, DIM, 0, true>(grid, warps, smem, s, A)
               : launch_one<T, DIM, 0, false>(grid, warps, smem, s, A);
  if (mode == 1)
    return vjp ? launch_one<T, DIM, 1, true>(grid, warps, smem, s, A)
               : launch_one<T, DIM, 1, false>(grid, warps, smem, s, A);
  return vjp ? launch_one<T, DIM, 2, true>(grid, warps, smem, s, A)
             : launch_one<T, DIM, 2, false>(grid, warps, smem, s, A);
}

template <typename T>
int launch(bool vjp, int mode, int dim, const void* hrec, const void* lo,
           const void* dense, const void* counts, const void* rows,
           const void* c0, const void* c1, const void* c2, void* o0, void* o1,
           void* o2, long long ncell, long long k_pad, long long block0,
           int B, int N, int half, int n_hi, int hcols, double res,
           double g0, double dg, double rad_hi, void* tally, int cull,
           void* stream) {
  if ((dim != 2 && dim != 3) || mode < 0 || mode > 2 || B < 1 || N < 1 ||
      half < 0 || n_hi < 2 || k_pad < 0 || ncell < 0 || block0 < 0 ||
      hcols < dim + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long F = dim == 3 ? 1LL * B * B * B : 1LL * B * B;
  if (F >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  if (ncell == 0) return static_cast<int>(cudaSuccess);
  const Shape sh = launch_shape(dim, B, ent_bytes<T>(dim, mode == 2),
                                mode == 1 ? sizeof(T) : 0);
  const long long warps = sh.L <= 32 ? (ncell + sh.G - 1) / sh.G
                                     : ncell * (sh.L / 32);
  const long long blocks = (warps + sh.W - 1) / sh.W;
  if (blocks > 0x7fffffffLL || sh.smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
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
  A.L = sh.L;
  A.G = sh.G;
  A.S = sh.S;
  A.Es = sh.Es;
  A.tiled = sh.tiled;
  A.warp_bytes = static_cast<int>(sh.warp_bytes);
  A.cull = cull != 0;
  A.res = static_cast<T>(res);
  A.g0 = static_cast<T>(g0);
  A.dg = static_cast<T>(dg);
  A.rad_hi = static_cast<T>(rad_hi);
  A.tally = static_cast<unsigned long long*>(tally);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const cudaError_t e = dim == 3
      ? launch_dim<T, 3>(mode, vjp, grid, sh.W, sh.smem, s, A)
      : launch_dim<T, 2>(mode, vjp, grid, sh.W, sh.smem, s, A);
  return static_cast<int>(e);
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers.
// mode: 0 offsets, 1 offsets with the radial axis in units of R_com
// (rdelta), 2 paint; dim 2 or 3. hrec (H, hcols), lo (H, dim) int64, dense
// (ncell, k_pad) int64, counts (ncell,) int64, rows (H, n_hi).
// grid_pass: o0..o2 the output planes (ncell B^dim each; dim of them in
// the offsets modes, one in paint), written, not added to; c0..c2 unused.
// grid_vjp: c0..c2 the cotangent planes, o0 the (H, n_hi) d_rows, added
// to with atomics. tally: null, or four uint64 (voxel-slots listed,
// voxel-slots inside, global atomic adds, (patch, slot) pairs culled)
// added to. cull: 0 walks every listed slot (the same planes and counts
// of slots and inside, bit for bit). Returns the launch's CUDA error (0 on
// success); the launch is asynchronous on `stream`.
#define GRID_ENTRY(NAME, T, VJP)                                             \
  extern "C" int NAME(int mode, int dim, const void* hrec, const void* lo,   \
                      const void* dense, const void* counts,                 \
                      const void* rows, const void* c0, const void* c1,      \
                      const void* c2, void* o0, void* o1, void* o2,          \
                      long long ncell, long long k_pad, long long block0,    \
                      int B, int N, int half, int n_hi, int hcols,           \
                      double res, double g0, double dg, double rad_hi,       \
                      void* tally, int cull, void* stream) {                 \
    return launch<T>(VJP, mode, dim, hrec, lo, dense, counts, rows, c0, c1,  \
                     c2, o0, o1, o2, ncell, k_pad, block0, B, N, half, n_hi, \
                     hcols, res, g0, dg, rad_hi, tally, cull, stream);       \
  }

GRID_ENTRY(grid_pass_f32, float, false)
GRID_ENTRY(grid_pass_f64, double, false)
GRID_ENTRY(grid_vjp_f32, float, true)
GRID_ENTRY(grid_vjp_f64, double, true)

// The shape of a launch for (mode, dim, B) in float32 (f64 = 0) or
// float64: out = {L, patches a warp, slots a stage S, row stride Es, warps
// a CTA, the CTA's dynamic shared memory in bytes}. Returns 0, or
// cudaErrorInvalidValue for a bad argument.
extern "C" int grid_launch_shape(int mode, int dim, int B, int f64,
                                 long long* out) {
  if ((dim != 2 && dim != 3) || mode < 0 || mode > 2 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long t = f64 ? sizeof(double) : sizeof(float);
  const Shape s = launch_shape(
      dim, B, f64 ? ent_bytes<double>(dim, mode == 2)
                  : ent_bytes<float>(dim, mode == 2),
      mode == 1 ? t : 0);
  out[0] = s.L;
  out[1] = s.G;
  out[2] = s.S;
  out[3] = s.Es;
  out[4] = s.W;
  out[5] = s.smem;
  return 0;
}
