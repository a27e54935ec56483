// Sorted scatter-add for Hopper (sm_90a): accs[c][idx[r]] += vals[c][r].
//
// Replaces the Pallas TPU kernel sorted_scatter_add_pallas
// (baryonification_tpu/ops/scatter_pallas.py, body _make_kernel). The
// contract is the same: rows arrive sorted by destination pixel, C = 1..3
// value planes (structure of arrays), accumulators updated in place, rows
// whose index is >= npix dropped. The caller sorts the rows and computes
// row_start[p] = first row whose destination is >= p * block_pix (both
// stay outside the kernel, as in the JAX package).
//
// Design. One CTA owns one block of block_pix destination pixels, so every
// output element has exactly one writer and no global atomics are needed.
// The CTA
//   1. reads its row range [row_start[p], row_start[p+1]); an empty range
//      exits at once, so the accumulators of untouched blocks are never
//      read or written;
//   2. zeroes a shared-memory tile covering only the destination span of
//      its rows (rows are sorted, so the span is idx[first]..idx[last]);
//   3. accumulates its rows into the tile with shared-memory atomicAdd;
//   4. adds the tile span into the global planes.
// The TPU kernel's one-hot (B, 128, 128) compare is not carried over: it
// exists because the TPU's vector unit has no scatter; Hopper's shared
// memory does.
//
// Bound: memory bytes. Each row costs one read of 4 + sizeof(T) * C bytes;
// each touched pixel one read and one write of sizeof(T) * C bytes. The
// design keeps that minimum: untouched blocks cost one row_start read,
// and the accumulation itself stays in shared memory. Contention on one
// shared address (many rows to one pixel) serialises inside a CTA; a
// block with very many rows is handled by one CTA. Making this fast
// (e.g. splitting long row ranges across CTAs) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
sorted_scatter_add_kernel(const int32_t* __restrict__ idx,
                          const int32_t* __restrict__ row_start,
                          const T* __restrict__ v0,
                          const T* __restrict__ v1,
                          const T* __restrict__ v2,
                          T* __restrict__ a0, T* __restrict__ a1,
                          T* __restrict__ a2,
                          int npix, int block_pix) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // C planes of block_pix

  const int p = blockIdx.x;
  const int start = row_start[p];
  const int end = row_start[p + 1];
  if (start >= end) return;  // uniform across the CTA

  const long long base = static_cast<long long>(p) * block_pix;
  // destination span of this block's rows (sorted rows: first and last)
  const int lo = static_cast<int>(idx[start] - base);
  const int hi = static_cast<int>(idx[end - 1] - base) + 1;
  const int span = hi - lo;

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
#pragma unroll
    for (int c = 0; c < C; ++c) tile[c * block_pix + i] = T(0);
  }
  __syncthreads();

  const T* vals[3] = {v0, v1, v2};
  for (int r = start + threadIdx.x; r < end; r += blockDim.x) {
    const int g = idx[r];
    const int local = static_cast<int>(g - base) - lo;
    if (g < npix && local >= 0 && local < span) {
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(&tile[c * block_pix + local], vals[c][r]);
    }
  }
  __syncthreads();

  T* accs[3] = {a0, a1, a2};
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long g = base + lo + i;
    if (g < npix) {
#pragma unroll
      for (int c = 0; c < C; ++c) accs[c][g] += tile[c * block_pix + i];
    }
  }
}

template <typename T, int C>
cudaError_t launch_c(const int32_t* idx, const int32_t* row_start, int n_blocks,
                     int block_pix, int npix, const T* v0, const T* v1,
                     const T* v2, T* a0, T* a1, T* a2, cudaStream_t stream) {
  const size_t smem = sizeof(T) * C * static_cast<size_t>(block_pix);
  cudaError_t err = cudaFuncSetAttribute(
      sorted_scatter_add_kernel<T, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sorted_scatter_add_kernel<T, C><<<n_blocks, kThreads, smem, stream>>>(
      idx, row_start, v0, v1, v2, a0, a1, a2, npix, block_pix);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* idx, const void* row_start, int n_blocks, int block_pix,
           int npix, int channels, const void* v0, const void* v1,
           const void* v2, void* a0, void* a1, void* a2, void* stream) {
  const int32_t* i = static_cast<const int32_t*>(idx);
  const int32_t* rs = static_cast<const int32_t*>(row_start);
  const T* w0 = static_cast<const T*>(v0);
  const T* w1 = static_cast<const T*>(v1);
  const T* w2 = static_cast<const T*>(v2);
  T* b0 = static_cast<T*>(a0);
  T* b1 = static_cast<T*>(a1);
  T* b2 = static_cast<T*>(a2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return static_cast<int>(cudaSuccess);
  switch (channels) {
    case 1: return static_cast<int>(launch_c<T, 1>(i, rs, n_blocks, block_pix, npix, w0, w1, w2, b0, b1, b2, s));
    case 2: return static_cast<int>(launch_c<T, 2>(i, rs, n_blocks, block_pix, npix, w0, w1, w2, b0, b1, b2, s));
    case 3: return static_cast<int>(launch_c<T, 3>(i, rs, n_blocks, block_pix, npix, w0, w1, w2, b0, b1, b2, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// unused value/accumulator planes may be null. Returns cudaGetLastError()
// of the launch (0 on success).
extern "C" int sorted_scatter_add_f32(const void* idx, const void* row_start,
                                      int n_blocks, int block_pix, int npix,
                                      int channels, const void* v0,
                                      const void* v1, const void* v2,
                                      void* a0, void* a1, void* a2,
                                      void* stream) {
  return launch<float>(idx, row_start, n_blocks, block_pix, npix, channels,
                       v0, v1, v2, a0, a1, a2, stream);
}

extern "C" int sorted_scatter_add_f64(const void* idx, const void* row_start,
                                      int n_blocks, int block_pix, int npix,
                                      int channels, const void* v0,
                                      const void* v1, const void* v2,
                                      void* a0, void* a1, void* a2,
                                      void* stream) {
  return launch<double>(idx, row_start, n_blocks, block_pix, npix, channels,
                        v0, v1, v2, a0, a1, a2, stream);
}
