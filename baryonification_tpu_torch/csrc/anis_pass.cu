// Anisotropic (density-dependent) 2D paint pass for Hopper (sm_90a): one
// bucket of halos painting every pixel of a block-major N^2 map at the log
// of an existing map's value (the canvas), and the pass's adjoint with
// respect to the halos' remap rows and the canvas.
//
// Replaces the candidate loop of the JAX package's grid_anis_paint_pass_2d
// (baryonification_tpu/runners/grid_cellmajor.py:722), which is XLA there
// (no TPU kernel): a lax.map over chunks of Morton blocks and a fori_loop
// over the candidates, each rebuilding the halo's remap row by a one-hot
// matmul and reading it with a hat readout. Here the row of every halo of
// the bucket is blended once beforehand (runners/grid_cellmajor.py
// halo_rows, H x (n_hi + 2) values) and a pixel-slot reads two nodes of it.
// The gradient of that pass is XLA autodiff of the same loop; anis_vjp is
// its first order in the rows and the canvas.
//
// Pixels are block-major: pixel p = c B^2 + f of block c (Morton id
// block0 + c), f = ox B + oy, at (ix, iy) = (bx B + ox, by B + oy). A row is
// ln Paint on the uniform ln Canvas grid q0 + dq j (j < n_hi), then the
// row's canvas range [lo, hi] (nodes n_hi, n_hi + 1). What one pixel
// computes (the plain version: runners/grid_cellmajor.py
// _AnisBucket.geometry and .values, stepped by _bucket_pass):
//   once:  lnv = log(v > 0 ? v : 1),  t = (lnv - q0) (1 / dq),
//          tc = clamp(t, 0, n_hi - 1),  i = min(floor tc, n_hi - 2),
//          w = tc - i
//   for each of the first counts[c] candidates h = dense[c K + k] of its
//   block whose halo is live (live_h):
//          u_d = (i_d - lo[h, d]) mod N,  dd_d = (u_d - hh[h]) res
//          inside: u_x < 2 hh[h], u_y < 2 hh[h], sqrt(dx^2 + dy^2) < reach[h]
//          paint = exp(lerp(row[i], row[i + 1], w))   (torch.lerp's branches)
//          out += paint  where inside, v > 0, lo <= lnv <= hi, paint finite
// Each test rounds as the plain PyTorch ops round on the card, so the
// kernel's counts of listed and inside pixel-slots equal the plain loop's
// census: nothing is contracted into an FMA (--fmad=false, _cuda_build.py),
// log and exp are the CUDA math library's, the scalars are taken in the
// hot dtype T, and the division by dq is a product with its reciprocal
// taken in T on the host (PyTorch's CUDA division by a CPU scalar).
//
// anis_vjp, for a cotangent plane ct, with g = ct paint for each slot that
// paints:
//   d_rows[h, i] += g (1 - w),  d_rows[h, i + 1] += g w   (torch.lerp's
//   backward; the range nodes take none)
//   d_canvas[p] = ((sum_slots g (row[i + 1] - row[i])) (1 / dq)) / v
//   where v > 0 and 0 <= t <= n_hi - 1 (torch.clamp's backward mask), else 0
// what autograd of the plain version gives, in another order of sums.
//
// What bounds it on this card: each bucket reads the canvas and writes a
// full plane, and tests every listed pixel-slot; the rows and per-halo
// columns are small and read from L1/L2. At anis-2048 the eight buckets'
// planes are ~0.08 ms of bytes at 3.35 TB/s against ~0.05 ms of
// operations, but its largest bucket (B = 32, 1e8 pixel-slots) is bound
// by its operations (0.020 ms against 0.013 ms of bytes). This first
// design is simple:
// 1. One thread a pixel. The canvas terms (log, t, the node and weight) are
//    taken once a pixel, not once a slot.
// 2. anis_pass: each pixel walks its block's slots in slot order and sums
//    them in registers; it is written once, with no atomics, so a launch is
//    deterministic.
// 3. anis_vjp: the same walk, the canvas gradient summed in registers and
//    written once; the row shares go out with red.global.add. A warp walks
//    its lanes' slot lists in lockstep (to the longest of them), and after
//    each slot the lanes whose shares land on the same node pair of the
//    same row (__match_any_sync on the first node) sum them in a tree of
//    shuffles; the lowest of them adds the sums.
// Slot, pixel and row indices are 32-bit (the wrapper refuses ncell B^2 or
// H (n_hi + 2) past 2^31 - 1); candidates, counts, half-windows and window
// starts are int32.
//
// Both entries take an optional tally: pixel-slots listed (a live halo's
// slot, once a pixel of its block), pixel-slots inside (the geometry's
// tests passed), and the adjoint's global atomic adds; summed a CTA at a
// time and added with one atomic a count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTally = 3;

template <typename T>
struct AnisArgs {
  const int* dense;           // (ncell, K) candidate halo ids
  const int* counts;          // (ncell,) candidates a block
  const int* hh;              // (H,) each halo's cutout half-window
  const int* lo;              // (H, 2) its window start (cen - hh)
  const T* reach;             // (H,) eps_max R_com
  const unsigned char* live;  // (H,) the halo has a row
  const T* rows;              // (H, S): n_hi nodes, then lo and hi
  const T* canvas;            // (ncell B^2,) block-major
  const T* ct;                // adjoint: (ncell B^2,) cotangent plane
  T* out;                     // pass: the plane; adjoint: d_canvas or null
  T* d_rows;                  // adjoint: (H, S), added to; or null
  int ncell, K, S, n_hi, B, F, N;
  unsigned block0;
  T q0, inv_dq, res, t_hi, i_hi;  // t_hi = n_hi - 1, i_hi = n_hi - 2
  unsigned long long* tally;      // null, or {slots, inside, atomics}
};

// the inverse of spreading 16 bits to every other bit (Morton ids)
__device__ __forceinline__ unsigned compact2(unsigned v) {
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  return (v | (v >> 8)) & 0x0000FFFFu;
}

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

// One thread a pixel (see the header): the pass (kVjp false) sums the
// pixel's painting slots in registers and writes it once; the adjoint
// (kVjp true) writes the pixel's canvas gradient once (where out is not
// null) and adds each painting slot's two node shares to d_rows (where
// not null), merged over the warp.
template <typename T, bool kVjp>
__global__ void __launch_bounds__(kThreads) anis_kernel(AnisArgs<T> A) {
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool real = p < static_cast<long long>(A.ncell) * A.F;
  unsigned n[kTally] = {0, 0, 0};  // slots inside atomics
  int c = 0, ix = 0, iy = 0, nk = 0, i = 0;
  T v = T(0), lnv = T(0), w = T(0), ct = T(0);
  bool vpos = false, in_t = false;
  if (real) {
    c = static_cast<int>(p / A.F);
    const int f = static_cast<int>(p) - c * A.F;
    const unsigned b = A.block0 + static_cast<unsigned>(c);
    ix = static_cast<int>(compact2(b)) * A.B + f / A.B;
    iy = static_cast<int>(compact2(b >> 1)) * A.B + f % A.B;
    nk = min(__ldg(A.counts + c), A.K);
    // the canvas terms, once a pixel
    v = __ldg(A.canvas + p);
    vpos = v > T(0);
    lnv = log(vpos ? v : T(1));
    const T t = (lnv - A.q0) * A.inv_dq;
    in_t = t >= T(0) && t <= A.t_hi;
    const T tc = fmin(fmax(t, T(0)), A.t_hi);
    const T fi = fmin(floor(tc), A.i_hi);
    i = static_cast<int>(fi);
    w = tc - fi;
    if (kVjp) ct = __ldg(A.ct + p);
  }
  const int* ids = A.dense + static_cast<long long>(c) * A.K;
  // the pass: its sum; the adjoint: sum of g (row[i + 1] - row[i])
  T acc = T(0);
  // the adjoint's lanes walk in lockstep, to the longest list of the warp
  const int k_end = kVjp ? __reduce_max_sync(kFull, nk) : nk;
  for (int k = 0; k < k_end; ++k) {
    int base = -1;
    T sh0 = T(0), sh1 = T(0);
    if (k < nk) {
      const int h = __ldg(ids + k);
      if (__ldg(A.live + h)) {
        ++n[0];
        const int hw = __ldg(A.hh + h);
        int ux = (ix - __ldg(A.lo + 2 * h)) % A.N;
        int uy = (iy - __ldg(A.lo + 2 * h + 1)) % A.N;
        ux += ux < 0 ? A.N : 0;
        uy += uy < 0 ? A.N : 0;
        if (ux < 2 * hw && uy < 2 * hw) {
          const T dx = static_cast<T>(ux - hw) * A.res;
          const T dy = static_cast<T>(uy - hw) * A.res;
          if (sqrt(dx * dx + dy * dy) < __ldg(A.reach + h)) {
            ++n[1];
            const int r0 = h * A.S;
            if (vpos && lnv >= __ldg(A.rows + r0 + A.n_hi) &&
                lnv <= __ldg(A.rows + r0 + A.n_hi + 1)) {
              const T a = __ldg(A.rows + r0 + i);
              const T e = __ldg(A.rows + r0 + i + 1);
              const T paint = exp(lerp(a, e, w));
              if (isfinite(paint)) {
                if constexpr (kVjp) {
                  const T g = ct * paint;
                  acc = acc + g * (e - a);
                  base = r0 + i;
                  sh0 = g * (T(1) - w);
                  sh1 = g * w;
                } else {
                  acc = acc + paint;
                }
              }
            }
          }
        }
      }
    }
    if constexpr (kVjp) {
      // lanes whose shares land on the same nodes add them once
      if (A.d_rows != nullptr && __any_sync(kFull, base >= 0)) {
        const unsigned peers = __match_any_sync(kFull, base);
        reduce_peers(peers, sh0, sh1);
        if (base >= 0 && lane == __ffs(peers) - 1) {
          atomicAdd(A.d_rows + base, sh0);
          atomicAdd(A.d_rows + base + 1, sh1);
          n[2] += 2;
        }
      }
    }
  }
  if (real && A.out != nullptr) {
    if constexpr (kVjp)
      A.out[p] = vpos && in_t ? (acc * A.inv_dq) / v : T(0);
    else
      A.out[p] = acc;
  }
  if (A.tally != nullptr) add_tally(A.tally, n);
}

template <typename T>
int launch(bool vjp, const void* dense, const void* counts, const void* hh,
           const void* lo, const void* reach, const void* live,
           const void* rows, const void* canvas, const void* ct, void* out,
           void* d_rows, long long ncell, long long K, long long H, int S,
           int B, int N, long long block0, double q0, double dq, double res,
           void* tally, void* stream) {
  const long long F = static_cast<long long>(B) * B;
  if (ncell < 0 || K < 0 || H < 0 || S < 4 || B < 1 || N < 1 ||
      block0 < 0 || block0 + ncell > 0xffffffffLL ||
      ncell * F > 0x7fffffffLL || H * S > 0x7fffffffLL || !(dq != 0.0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncell == 0) return static_cast<int>(cudaSuccess);
  AnisArgs<T> A;
  A.dense = static_cast<const int*>(dense);
  A.counts = static_cast<const int*>(counts);
  A.hh = static_cast<const int*>(hh);
  A.lo = static_cast<const int*>(lo);
  A.reach = static_cast<const T*>(reach);
  A.live = static_cast<const unsigned char*>(live);
  A.rows = static_cast<const T*>(rows);
  A.canvas = static_cast<const T*>(canvas);
  A.ct = static_cast<const T*>(ct);
  A.out = static_cast<T*>(out);
  A.d_rows = static_cast<T*>(d_rows);
  A.ncell = static_cast<int>(ncell);
  A.K = static_cast<int>(K);
  A.S = S;
  A.n_hi = S - 2;
  A.B = B;
  A.F = static_cast<int>(F);
  A.N = N;
  A.block0 = static_cast<unsigned>(block0);
  // the scalars in T, as PyTorch casts a Python scalar to the op's dtype;
  // the reciprocal taken in T (its CUDA division by a CPU scalar)
  A.q0 = static_cast<T>(q0);
  A.inv_dq = T(1) / static_cast<T>(dq);
  A.res = static_cast<T>(res);
  A.t_hi = static_cast<T>(S - 3);
  A.i_hi = static_cast<T>(S - 4);
  A.tally = static_cast<unsigned long long*>(tally);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((ncell * F + kThreads - 1) /
                                              kThreads);
  if (vjp)
    anis_kernel<T, true><<<grid, kThreads, 0, s>>>(A);
  else
    anis_kernel<T, false><<<grid, kThreads, 0, s>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers.
// dense (ncell, K) int32, counts (ncell,) int32, hh (H,) int32, lo (H, 2)
// int32, reach (H,), live (H,) bool, rows (H, S) with S = n_hi + 2, canvas
// (ncell B^2,) block-major. anis_pass: out the plane (ncell B^2), written,
// not added to; ct and d_rows unused. anis_vjp: ct the cotangent plane,
// out the canvas gradient (written; null: not taken), d_rows the (H, S)
// rows' gradient (added to with atomics; null: not taken). tally: null, or
// three uint64 (pixel-slots listed, inside, global atomic adds) added to.
// Returns the launch's CUDA error (0 on success); the launch is
// asynchronous on `stream`.
#define ANIS_ENTRY(NAME, T, VJP)                                              \
  extern "C" int NAME(const void* dense, const void* counts, const void* hh,  \
                      const void* lo, const void* reach, const void* live,    \
                      const void* rows, const void* canvas, const void* ct,   \
                      void* out, void* d_rows, long long ncell, long long K,  \
                      long long H, int S, int B, int N, long long block0,     \
                      double q0, double dq, double res, void* tally,          \
                      void* stream) {                                         \
    return launch<T>(VJP, dense, counts, hh, lo, reach, live, rows, canvas,   \
                     ct, out, d_rows, ncell, K, H, S, B, N, block0, q0, dq,   \
                     res, tally, stream);                                     \
  }

ANIS_ENTRY(anis_pass_f32, float, false)
ANIS_ENTRY(anis_pass_f64, double, false)
ANIS_ENTRY(anis_vjp_f32, float, true)
ANIS_ENTRY(anis_vjp_f64, double, true)
