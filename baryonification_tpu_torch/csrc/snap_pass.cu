// Cell-major particle-snapshot pass for Hopper (sm_90a): one bucket of
// halos displacing every padded particle slot of a periodic box's
// cell-list cells, and the pass's adjoint with respect to the halos'
// radial rows.
//
// Replaces the candidate loop of the JAX package's snapshot_offsets_pass
// (baryonification_tpu/runners/snapshot_cellmajor.py:89), which is XLA
// there (no TPU kernel): a lax.map over chunks of cells and a fori_loop
// over the candidates, each rebuilding the halo's radial row by a one-hot
// matmul and reading it with a segment reduction. Here the row of every
// halo of the bucket is blended once beforehand (runners/grid_cellmajor.py
// halo_rows, H x n_hi values) and a pair reads two nodes of it. The
// gradient of that pass is XLA autodiff of the same loop; snap_vjp is its
// first order in the rows.
//
// The particles are padded per cell (runners/snapshot_cellmajor.py
// pad_particles_by_cell): slot p of cell c is element c P + p of three
// position planes, the first counts_p[c] slots real, the others masked.
// What one real slot computes, over the first counts_h[c] candidates
// h = dense[c K + k] of its cell, in candidate order (the plain version:
// runners/snapshot_cellmajor.py _SnapBucket.geometry and .values, stepped
// by runners/grid_cellmajor.py _bucket_pass):
//   v_d  = x_d - hrec[h, d]
//   dx_d = v_d - L rint(v_d (1 / L))     the minimum image
//   r    = sqrt((dx_0^2 + dx_1^2) + dx_2^2)
//   rad  = log(max(r, 1e-30)), less ln R_com (hrec[h, 4]) under Rdelta
//   t = (rad - g0) (1 / dg),  i = clamp(floor t, 0, n_hi - 2),  w = t - i
//   live = g0 <= rad <= rad_hi and r < reach (hrec[h, 3])
//   v = lerp(rows[h, i], rows[h, i + 1], w)   (torch.lerp's two branches)
//   out_d += ((v a_scale) / max(r, 1e-30)) dx_d   where live and v finite
// Each test rounds as the plain PyTorch ops round on the card, so the
// kernel's count of live pairs equals the plain loop's census: nothing is
// contracted into an FMA (--fmad=false, _cuda_build.py), the scalars are
// taken in the hot dtype T, and a division by a Python scalar is a product
// with its reciprocal, taken in T on the host (PyTorch's CUDA division by
// a CPU scalar). Rows of halos outside the table's mass grid are NaN, so
// their pairs add nothing.
//
// snap_vjp, for cotangent planes ct_d: each live pair with a finite value
// adds g (1 - w) and g w to nodes i and i + 1 of its halo's row,
// g = (((ct_0 dx_0 + ct_1 dx_1) + ct_2 dx_2) / max(r, 1e-30)) a_scale:
// what autograd of the plain version gives (the backward of torch.lerp is
// g (1 - w), g w), in another order of operations.
//
// What bounds it on this card: issued instructions and their latency, not
// bytes. Each slot is read once and written once, the candidate lists are
// 4 bytes a (cell, candidate), and the rows and records are small and read
// from L1/L2; every listed (particle, halo) pair is tested (snap-5e6's
// largest bucket lists 1.1e8, a third inside). The design:
//
// 1. A warp owns one cell, its lanes the cell's slots, 32 at a time (a
//    cell of P > 32 slots takes ceil(P / 32) rounds, each walking the
//    cell's list again), so every lane of a warp reads the same halo at a
//    time. A round whose slots are all padding walks nothing and writes
//    zeros.
// 2. The list is read 32 candidates at a time: lane j loads candidate
//    k0 + j's id and record (one coalesced id load, the records in
//    parallel), and the walk takes each candidate's from its lane by
//    shuffles, so a candidate costs no dependent load.
// 3. The cheap exact test first: live is a conjunction, so r < reach runs
//    right after the square root and before the log; a warp whose lanes
//    all fail it skips the log, the division and the row read.
// 4. snap_pass: each slot sums its candidates in order in registers and is
//    written once: no atomics, so a launch is deterministic.
// 5. snap_vjp: after each candidate the lanes whose shares land on the
//    same node pair of its row (__match_any_sync on the first node) sum
//    them in a tree of shuffles, and the lowest of them adds the sums with
//    two red.global.add.
// Slot and row indices are 32-bit (the wrapper refuses ncell P or
// H n_hi past 2^31 - 1).
//
// Both entries take an optional tally: (particle, halo) pairs listed (real
// slots times listed candidates), pairs inside (live), and the adjoint's
// global atomic adds; summed a CTA at a time and added with one atomic a
// count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTally = 3;

template <typename T>
struct SnapArgs {
  const T* pos[3];        // padded particle planes (ncell P each)
  const int* counts_p;    // (ncell,) real slots a cell
  const int* dense;       // (ncell, K) candidate halo ids
  const int* counts_h;    // (ncell,) candidates a cell
  const T* hrec;          // (H, hcols): x, y, z, reach [, ln R_com]
  const T* rows;          // (H, n_hi)
  const T* ct[3];         // adjoint: cotangent planes (ncell P each)
  T* out[3];              // pass: output planes; adjoint: out[0] = d_rows
  int ncell, K, P, n_hi, hcols;
  T g0, inv_dg, rad_hi, a_scale, L, inv_L;
  unsigned long long* tally;  // null, or {pairs, inside, atomics}
};

// torch.round: half to even
__device__ __forceinline__ float round_even(float v) { return rintf(v); }
__device__ __forceinline__ double round_even(double v) { return rint(v); }

// torch.lerp (ATen's Lerp.h): the weight's half decides the form
template <typename T>
__device__ __forceinline__ T lerp(T a, T b, T w) {
  return fabs(w) < T(0.5) ? a + w * (b - a) : b - (b - a) * (T(1) - w);
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
    for (int j = 0; j < kWarps; ++j) s += part[threadIdx.x][j];
    if (s != 0) atomicAdd(tally + threadIdx.x, s);
  }
}

// One warp a cell (see the header): the pass (kVjp false) sums each real
// slot's live pairs in registers and writes every slot of the cell once;
// the adjoint (kVjp true) reads the slots' cotangents and adds each live
// finite pair's two node shares to d_rows (out[0]), merged over the warp.
template <typename T, bool kRdelta, bool kVjp>
__global__ void __launch_bounds__(kThreads) snap_kernel(SnapArgs<T> A) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  unsigned n[kTally] = {0, 0, 0};  // pairs inside atomics
  if (c < A.ncell) {
    const int np = min(__ldg(A.counts_p + c), A.P);
    const int nh = min(__ldg(A.counts_h + c), A.K);
    const int* ids = A.dense + static_cast<long long>(c) * A.K;
    for (int p0 = 0; p0 < A.P; p0 += 32) {
      const int p = p0 + lane;
      const int s = p < A.P ? c * A.P + p : 0;
      const bool real = p < np;
      T x[3], acc[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        x[d] = real ? __ldg(A.pos[d] + s) : T(0);
        acc[d] = kVjp && real ? __ldg(A.ct[d] + s) : T(0);
      }
      if (real) n[0] += static_cast<unsigned>(nh);
      // a round of padding slots only walks nothing
      for (int k0 = 0; p0 < np && k0 < nh; k0 += 32) {
        // lane j holds candidate k0 + j's id and record
        int hl = 0;
        T cl[3] = {T(0), T(0), T(0)}, reach_l = T(0), lnr_l = T(0);
        if (k0 + lane < nh) {
          hl = __ldg(ids + k0 + lane);
          const T* rec = A.hrec + static_cast<long long>(hl) * A.hcols;
#pragma unroll
          for (int d = 0; d < 3; ++d) cl[d] = __ldg(rec + d);
          reach_l = __ldg(rec + 3);
          if (kRdelta) lnr_l = __ldg(rec + 4);
        }
        const int kn = min(32, nh - k0);
        for (int j = 0; j < kn; ++j) {
          const int h = __shfl_sync(kFull, hl, j);
          T hc[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) hc[d] = __shfl_sync(kFull, cl[d], j);
          const T reach = __shfl_sync(kFull, reach_l, j);
          const T lnR = kRdelta ? __shfl_sync(kFull, lnr_l, j) : T(0);
          int base = -1;
          T sh0 = T(0), sh1 = T(0);
          if (real) {
            T dx[3];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const T v = x[d] - hc[d];
              dx[d] = v - A.L * round_even(v * A.inv_L);
            }
            const T r = sqrt((dx[0] * dx[0] + dx[1] * dx[1]) + dx[2] * dx[2]);
            // the cheap exact test first
            if (r < reach) {
              T rad = log(fmax(r, static_cast<T>(1e-30)));
              if (kRdelta) rad = rad - lnR;
              if (rad >= A.g0 && rad <= A.rad_hi) {
                ++n[1];
                const T t = (rad - A.g0) * A.inv_dg;
                const T i = fmin(fmax(floor(t), T(0)),
                                 static_cast<T>(A.n_hi - 2));
                const T w = t - i;
                const int b0 = h * A.n_hi + static_cast<int>(i);
                const T v = lerp(__ldg(A.rows + b0), __ldg(A.rows + b0 + 1),
                                 w);
                if (isfinite(v)) {
                  const T rr = fmax(r, static_cast<T>(1e-30));
                  if constexpr (kVjp) {
                    const T g =
                        (((acc[0] * dx[0] + acc[1] * dx[1]) + acc[2] * dx[2]) /
                         rr) * A.a_scale;
                    base = b0;
                    sh0 = g * (T(1) - w);
                    sh1 = g * w;
                  } else {
                    const T scale = (v * A.a_scale) / rr;
#pragma unroll
                    for (int d = 0; d < 3; ++d)
                      acc[d] = acc[d] + scale * dx[d];
                  }
                }
              }
            }
          }
          if constexpr (kVjp) {
            // lanes whose shares land on the same nodes add them once
            if (__any_sync(kFull, base >= 0)) {
              const unsigned peers = __match_any_sync(kFull, base);
              reduce_peers(peers, sh0, sh1);
              if (base >= 0 && lane == __ffs(peers) - 1) {
                atomicAdd(A.out[0] + base, sh0);
                atomicAdd(A.out[0] + base + 1, sh1);
                n[2] += 2;
              }
            }
          }
        }
      }
      if constexpr (!kVjp) {
        if (p < A.P) {
#pragma unroll
          for (int d = 0; d < 3; ++d) A.out[d][s] = acc[d];
        }
      }
    }
  }
  if (A.tally != nullptr) add_tally(A.tally, n);
}

template <typename T, bool kRdelta, bool kVjp>
cudaError_t launch_one(unsigned grid, cudaStream_t s, const SnapArgs<T>& A) {
  snap_kernel<T, kRdelta, kVjp><<<grid, kThreads, 0, s>>>(A);
  return cudaGetLastError();
}

template <typename T>
int launch(bool vjp, int rdelta, const void* px, const void* py,
           const void* pz, const void* counts_p, const void* dense,
           const void* counts_h, const void* hrec, const void* rows,
           const void* c0, const void* c1, const void* c2, void* o0, void* o1,
           void* o2, long long ncell, long long K, long long P, long long H,
           int n_hi, int hcols, double g0, double dg, double rad_hi,
           double a_scale, double L, void* tally, void* stream) {
  if (ncell < 0 || K < 0 || P < 1 || H < 0 || n_hi < 2 ||
      hcols != 4 + (rdelta != 0) || ncell * P > 0x7fffffffLL ||
      H * n_hi > 0x7fffffffLL || !(dg != 0.0) || !(L > 0.0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncell == 0) return static_cast<int>(cudaSuccess);
  SnapArgs<T> A;
  A.pos[0] = static_cast<const T*>(px);
  A.pos[1] = static_cast<const T*>(py);
  A.pos[2] = static_cast<const T*>(pz);
  A.counts_p = static_cast<const int*>(counts_p);
  A.dense = static_cast<const int*>(dense);
  A.counts_h = static_cast<const int*>(counts_h);
  A.hrec = static_cast<const T*>(hrec);
  A.rows = static_cast<const T*>(rows);
  A.ct[0] = static_cast<const T*>(c0);
  A.ct[1] = static_cast<const T*>(c1);
  A.ct[2] = static_cast<const T*>(c2);
  A.out[0] = static_cast<T*>(o0);
  A.out[1] = static_cast<T*>(o1);
  A.out[2] = static_cast<T*>(o2);
  A.ncell = static_cast<int>(ncell);
  A.K = static_cast<int>(K);
  A.P = static_cast<int>(P);
  A.n_hi = n_hi;
  A.hcols = hcols;
  // the scalars in T, as PyTorch casts a Python scalar to the op's dtype;
  // the reciprocals taken in T (its CUDA division by a CPU scalar)
  A.g0 = static_cast<T>(g0);
  A.inv_dg = T(1) / static_cast<T>(dg);
  A.rad_hi = static_cast<T>(rad_hi);
  A.a_scale = static_cast<T>(a_scale);
  A.L = static_cast<T>(L);
  A.inv_L = T(1) / static_cast<T>(L);
  A.tally = static_cast<unsigned long long*>(tally);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((ncell + kWarps - 1) / kWarps);
  cudaError_t e;
  if (rdelta)
    e = vjp ? launch_one<T, true, true>(grid, s, A)
            : launch_one<T, true, false>(grid, s, A);
  else
    e = vjp ? launch_one<T, false, true>(grid, s, A)
            : launch_one<T, false, false>(grid, s, A);
  return static_cast<int>(e);
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers.
// px, py, pz the padded particle planes (ncell P each), counts_p (ncell,)
// int32, dense (ncell, K) int32, counts_h (ncell,) int32, hrec (H, hcols)
// with hcols 5 under rdelta (the fifth ln R_com) and 4 otherwise, rows
// (H, n_hi). snap_pass: o0..o2 the output planes (ncell P each), written,
// not added to; c0..c2 unused. snap_vjp: c0..c2 the cotangent planes, o0
// the (H, n_hi) d_rows, added to with atomics. tally: null, or three
// uint64 (pairs listed, pairs inside, global atomic adds) added to.
// Returns the launch's CUDA error (0 on success); the launch is
// asynchronous on `stream`.
#define SNAP_ENTRY(NAME, T, VJP)                                             \
  extern "C" int NAME(int rdelta, const void* px, const void* py,            \
                      const void* pz, const void* counts_p,                  \
                      const void* dense, const void* counts_h,               \
                      const void* hrec, const void* rows, const void* c0,    \
                      const void* c1, const void* c2, void* o0, void* o1,    \
                      void* o2, long long ncell, long long K, long long P,   \
                      long long H, int n_hi, int hcols, double g0,           \
                      double dg, double rad_hi, double a_scale, double L,    \
                      void* tally, void* stream) {                           \
    return launch<T>(VJP, rdelta, px, py, pz, counts_p, dense, counts_h,     \
                     hrec, rows, c0, c1, c2, o0, o1, o2, ncell, K, P, H,     \
                     n_hi, hcols, g0, dg, rad_hi, a_scale, L, tally, stream); \
  }

SNAP_ENTRY(snap_pass_f32, float, false)
SNAP_ENTRY(snap_pass_f64, double, false)
SNAP_ENTRY(snap_vjp_f32, float, true)
SNAP_ENTRY(snap_vjp_f64, double, true)
