// Scatter-add for Hopper (sm_90a): accs[c][idx[r]] += vals[c][r].
//
// Replaces the Pallas TPU kernel sorted_scatter_add_pallas
// (baryonification_tpu/ops/scatter_pallas.py, body _make_kernel). The
// function is the same: C = 1..3 value planes (structure of arrays), the
// accumulators updated in place, rows whose index lies outside [0, npix)
// dropped. What is not carried over is the sort. The TPU kernel needs
// rows sorted by destination because its vector unit has no scatter; this
// card adds in its L2 cache (red.global.add), so the rows are taken in
// whatever order the caller made them and the whole scatter is this one
// launch: no sort, no gather of the values, no row-range search.
//
// Design. One thread per row, the grid sized by the rows and not by the
// map. A thread reads its index (coalesced), and a row that is aimed at a
// pixel reads its C values and adds each with an atomicAdd whose result is
// unused, which nvcc emits as red.global.add.f32 / .f64. A warp whose 32
// rows are all dropped exits after the index load. Before the adds, a
// warp looks for runs of equal destinations in neighbouring lanes (one
// shuffle and one vote). The runners' rows are windows of consecutive
// pixels, so mostly there is none and every lane adds for itself. Where
// there are runs (rows sorted by destination, many rows on one pixel)
// each run is summed by a segmented shuffle reduction and its first lane
// issues one add, so such an input does not queue on one L2 address.
// Equal destinations in lanes that are not neighbours are left to the L2.
//
// Bound: memory bytes. Each row costs one read of 4 bytes, each row aimed
// at a pixel sizeof(T) * C more, and each touched pixel one read and one
// write of sizeof(T) * C bytes. The kernel reads nothing twice; the adds
// land in L2 and each touched line is written back once. Sums arrive in
// an order that differs from run to run (rounding only).
//
// The backward (scatter_add_vjp_f32 / _f64) replaces the VJP of the Pallas
// kernel, _sorted_scatter_bwd (scatter_pallas.py): the accumulators'
// cotangent passes through unchanged (the caller keeps it), and each
// row's value cotangent is the masked gather d[c][r] = g[c][idx[r]] for a
// row aimed at a pixel, 0 for a dropped one. One thread a row, 1-3 planes
// a launch; every row is written once, so the result is exact and the
// same from run to run. Bound: memory bytes, 4 bytes of index a row and,
// a plane, sizeof(T) gathered (a row aimed at a pixel) and sizeof(T)
// written.
//
// Both entries take fewer than 2^31 rows a launch (int row counts); the
// caller cuts longer inputs into chunks (ops/scatter_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int32_t* __restrict__ idx,
                   const T* __restrict__ v0, const T* __restrict__ v1,
                   const T* __restrict__ v2, T* __restrict__ a0,
                   T* __restrict__ a1, T* __restrict__ a2, int n_rows,
                   int npix) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int g = r < n_rows ? idx[r] : -1;
  const bool live =
      static_cast<unsigned>(g) < static_cast<unsigned>(npix);
  if (!__any_sync(kFull, live)) return;  // uniform across the warp

  const T* vals[3] = {v0, v1, v2};
  T* accs[3] = {a0, a1, a2};
  T v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = live ? vals[c][r] : T(0);

  // runs of equal destinations in neighbouring lanes; dropped rows share
  // the key -1 and never add
  const int key = live ? g : -1;
  const int prev = __shfl_up_sync(kFull, key, 1);
  const bool head = lane == 0 || prev != key;
  if (__any_sync(kFull, live && !head)) {
    // segmented suffix sums: the run of lane i ends before the next head
    const unsigned heads = __ballot_sync(kFull, head);
    const unsigned above = lane == 31 ? 0u : heads & (kFull << (lane + 1));
    const int end = above ? __ffs(above) - 1 : 32;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T t = __shfl_down_sync(kFull, v[c], off);
        if (lane + off < end) v[c] += t;
      }
    }
    if (!head) return;
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(&accs[c][g], v[c]);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
scatter_add_vjp_kernel(const int32_t* __restrict__ idx,
                       const T* __restrict__ g0, const T* __restrict__ g1,
                       const T* __restrict__ g2, T* __restrict__ d0,
                       T* __restrict__ d1, T* __restrict__ d2, int n_rows,
                       int npix) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  const int g = __ldg(idx + r);
  const bool live =
      static_cast<unsigned>(g) < static_cast<unsigned>(npix);
  const T* cts[3] = {g0, g1, g2};
  T* outs[3] = {d0, d1, d2};
#pragma unroll
  for (int c = 0; c < C; ++c) outs[c][r] = live ? __ldg(cts[c] + g) : T(0);
}

template <typename T>
int launch_vjp(const void* idx, int n_rows, int npix, int channels,
               const void* g0, const void* g1, const void* g2, void* d0,
               void* d1, void* d2, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* h0 = static_cast<const T*>(g0);
  const T* h1 = static_cast<const T*>(g1);
  const T* h2 = static_cast<const T*>(g2);
  T* e0 = static_cast<T*>(d0);
  T* e1 = static_cast<T*>(d1);
  T* e2 = static_cast<T*>(d2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (static_cast<unsigned>(n_rows) + kThreads - 1) / kThreads;
  switch (channels) {
    case 1:
      scatter_add_vjp_kernel<T, 1><<<grid, kThreads, 0, s>>>(i, h0, h1, h2, e0, e1, e2, n_rows, npix);
      break;
    case 2:
      scatter_add_vjp_kernel<T, 2><<<grid, kThreads, 0, s>>>(i, h0, h1, h2, e0, e1, e2, n_rows, npix);
      break;
    case 3:
      scatter_add_vjp_kernel<T, 3><<<grid, kThreads, 0, s>>>(i, h0, h1, h2, e0, e1, e2, n_rows, npix);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* idx, int n_rows, int npix, int channels,
           const void* v0, const void* v1, const void* v2, void* a0,
           void* a1, void* a2, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* w0 = static_cast<const T*>(v0);
  const T* w1 = static_cast<const T*>(v1);
  const T* w2 = static_cast<const T*>(v2);
  T* b0 = static_cast<T*>(a0);
  T* b1 = static_cast<T*>(a1);
  T* b2 = static_cast<T*>(a2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (static_cast<unsigned>(n_rows) + kThreads - 1) / kThreads;
  switch (channels) {
    case 1:
      scatter_add_kernel<T, 1><<<grid, kThreads, 0, s>>>(i, w0, w1, w2, b0, b1, b2, n_rows, npix);
      break;
    case 2:
      scatter_add_kernel<T, 2><<<grid, kThreads, 0, s>>>(i, w0, w1, w2, b0, b1, b2, n_rows, npix);
      break;
    case 3:
      scatter_add_kernel<T, 3><<<grid, kThreads, 0, s>>>(i, w0, w1, w2, b0, b1, b2, n_rows, npix);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// unused value/accumulator planes may be null. Returns cudaGetLastError()
// of the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int scatter_add_f32(const void* idx, int n_rows, int npix,
                               int channels, const void* v0, const void* v1,
                               const void* v2, void* a0, void* a1, void* a2,
                               void* stream) {
  return launch<float>(idx, n_rows, npix, channels, v0, v1, v2, a0, a1, a2,
                       stream);
}

extern "C" int scatter_add_f64(const void* idx, int n_rows, int npix,
                               int channels, const void* v0, const void* v1,
                               const void* v2, void* a0, void* a1, void* a2,
                               void* stream) {
  return launch<double>(idx, n_rows, npix, channels, v0, v1, v2, a0, a1, a2,
                        stream);
}

// The backward: d[c][r] = g[c][idx[r]] for rows aimed at a pixel, else 0.
// g are the accumulators' cotangent planes (npix each), d the value
// cotangent planes (n_rows each); unused planes may be null.
extern "C" int scatter_add_vjp_f32(const void* idx, int n_rows, int npix,
                                   int channels, const void* g0,
                                   const void* g1, const void* g2, void* d0,
                                   void* d1, void* d2, void* stream) {
  return launch_vjp<float>(idx, n_rows, npix, channels, g0, g1, g2, d0, d1,
                           d2, stream);
}

extern "C" int scatter_add_vjp_f64(const void* idx, int n_rows, int npix,
                                   int channels, const void* g0,
                                   const void* g1, const void* g2, void* d0,
                                   void* d1, void* d2, void* stream) {
  return launch_vjp<double>(idx, n_rows, npix, channels, g0, g1, g2, d0, d1,
                            d2, stream);
}
