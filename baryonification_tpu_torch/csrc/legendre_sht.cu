// Scaled Legendre recurrences of the SHT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of baryonification_tpu/ops/spectra.py:
//   legendre_alm_*   <- _legendre_alm_pallas   (analysis, anafast/map2alm)
//   legendre_synth_* <- _legendre_synth_pallas (synthesis, alm2map)
// Both run, for every m and every ell >= m, the normalised
// associated-Legendre recurrence on the R = 2*nside northern rings of the
// equator-folded map, in the scaled form lambda = p * FOLD^-sc of the JAX
// package: a lane whose |p| exceeds BIG while its counter sc is positive
// is divided by FOLD, and only lanes with sc == 0 contribute. Each step is
// the JAX scan body (spectra.py:615-642): the clamped al/al1 factors, the
// seed at l == m with p2 <- 0, the rescale, and the (l+m) parity select.
//   analysis:  A[l, m] = sum_r lambda_lm(x_r) * (l+m even ? Ge : Go)[m, r]
//   synthesis: B{e,o}[m, r] = sum_{l>=m, l+m even/odd} a[l, m] lambda_lm(x_r)
//
// Design. One CTA per m (blockIdx.x = m), so the ell loop starts at l = m
// exactly and no work is spent on the m > l triangle. Row m runs L - m
// steps, and CTAs are issued in blockIdx order, so the heavy rows start
// first and the tail is short. The threads share the R rings, RPT strided
// rings each, with x, the inputs, p1, p2 and sc held in registers for the
// whole loop: nothing but the results goes back to device memory. (The
// TPU kernel blocks MB rows of m and keeps the carries in VMEM instead;
// its one-hot lane tricks exist for Mosaic layouts and are not carried
// over.)
//   - analysis: the per-step sum over rings is a warp-shuffle reduction;
//     lane 0 of each warp stages its partial in shared memory for a tile
//     of kTile steps, so the CTA synchronises once per tile, not per step,
//     and then writes A[l, m] for the tile's l. The wrapper zeroes A, so
//     the m > l triangle stays zero.
//   - synthesis: the column a[:, m] (re and im) is copied into shared
//     memory once; each thread keeps its rings' four fold sums in
//     registers and writes [m, r] once at the end. No cross-thread
//     reduction.
//
// Bound: operations. Each kernel makes L(L+1)/2 * R (m, l, ring) updates,
// ~8 flops each (4 in the recurrence, 2 FMAs into the sums); at NSIDE
// 1024 / lmax 2048 that is 4.30e9 updates, 3.4e10 flops: ~0.5 ms at the
// H100's 67 TFLOP/s of non-tensor f32 (twice that in f64). The bytes, each
// input read once and each output written once, are ~134 MB, ~40 us at
// 3.35 TB/s. So both kernels are compute-bound; the design keeps all
// state in registers and the per-step reduction in shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTile = 32;  // ell steps per shared-memory tile (analysis)

template <typename T>
struct Scaling;
template <>
struct Scaling<float> {
  // as the JAX package's f32 path: FOLD 1e20, BIG 1e10, 1/FOLD rounded
  // once from double
  static __device__ float inv_fold() { return static_cast<float>(1.0 / 1e20); }
  static __device__ float big() { return 1e10f; }
};
template <>
struct Scaling<double> {
  static __device__ double inv_fold() { return 1.0 / 1e40; }
  static __device__ double big() { return 1e20; }
};

__device__ __forceinline__ float bt_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double bt_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float bt_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double bt_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float bt_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double bt_abs(double v) { return fabs(v); }
// Rounded products and differences that the compiler may not contract
// into FMAs: the recurrence then rounds exactly as the plain PyTorch
// version does, step for step, so the two agree to the order of the
// final sums and not to an error grown over thousands of steps.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// The two recurrence factors of step l for row m, computed in T exactly
// as the JAX package does (factored (l-m)(l+m) forms; the clamps only
// bite where the seed or p2 == 0 discards the result).
template <typename T>
__device__ __forceinline__ void factors(int l, int m, T* al, T* inv_al1) {
  const T lf = static_cast<T>(l), mf = static_cast<T>(m);
  const T half = static_cast<T>(0.5);
  *al = bt_sqrt(bt_max((2 * lf - 1) * (2 * lf + 1), half) /
                bt_max((lf - mf) * (lf + mf), half));
  const T al1 = bt_sqrt(bt_max((2 * lf - 3) * (2 * lf - 1), half) /
                        bt_max((lf - 1 - mf) * (lf - 1 + mf), half));
  *inv_al1 = static_cast<T>(1) / al1;
}

// One scaled step for one ring; returns lambda (0 while still scaled).
template <typename T>
__device__ __forceinline__ T step(bool seed, T seed_p, int seed_sc, T x,
                                  T al, T inv_al1, T& p1, T& p2, int& sc) {
  T p;
  if (seed) {
    p = seed_p;
    sc = seed_sc;
  } else {
    p = mul_rn(al, sub_rn(mul_rn(x, p1), mul_rn(p2, inv_al1)));
  }
  const bool grow = (bt_abs(p) > Scaling<T>::big()) && (sc > 0);
  if (grow) p = mul_rn(p, Scaling<T>::inv_fold());
  p2 = seed ? static_cast<T>(0)
            : (grow ? mul_rn(p1, Scaling<T>::inv_fold()) : p1);
  sc -= grow ? 1 : 0;
  p1 = p;
  return sc == 0 ? p : static_cast<T>(0);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int RPT>
__global__ void __launch_bounds__(kMaxThreads)
legendre_alm_kernel(const T* __restrict__ Ger, const T* __restrict__ Gor,
                    const T* __restrict__ Gei, const T* __restrict__ Goi,
                    const T* __restrict__ pmm, const T* __restrict__ xs,
                    const int32_t* __restrict__ sc0, T* __restrict__ Ar,
                    T* __restrict__ Ai, int L, int R) {
  __shared__ T part_r[kTile][kMaxThreads / 32];
  __shared__ T part_i[kTile][kMaxThreads / 32];
  const int m = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  const size_t row = static_cast<size_t>(m) * R;

  // rings beyond R hold zeros: no seed, no G, so they contribute nothing
  T x[RPT], ger[RPT], gor[RPT], gei[RPT], goi[RPT], p1[RPT], p2[RPT];
  int sc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = tid + k * nt;
    const bool in = r < R;
    x[k] = in ? xs[r] : T(0);
    ger[k] = in ? Ger[row + r] : T(0);
    gor[k] = in ? Gor[row + r] : T(0);
    gei[k] = in ? Gei[row + r] : T(0);
    goi[k] = in ? Goi[row + r] : T(0);
    p1[k] = T(0);
    p2[k] = T(0);
    sc[k] = 0;
  }

  for (int l0 = m; l0 < L; l0 += kTile) {
    const int nl = min(kTile, L - l0);
    for (int j = 0; j < nl; ++j) {
      const int l = l0 + j;
      const bool seed = (l == m);
      const bool even = ((l + m) & 1) == 0;
      T al, inv_al1;
      factors(l, m, &al, &inv_al1);
      T sr = T(0), si = T(0);
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = tid + k * nt;
        T seed_p = T(0);
        int seed_sc = 0;
        if (seed && r < R) {
          seed_p = pmm[row + r];
          seed_sc = sc0[row + r];
        }
        const T lam = step(seed, seed_p, seed_sc, x[k], al, inv_al1, p1[k],
                           p2[k], sc[k]);
        sr += (even ? ger[k] : gor[k]) * lam;
        si += (even ? gei[k] : goi[k]) * lam;
      }
      sr = warp_sum(sr);
      si = warp_sum(si);
      if (lane == 0) {
        part_r[j][warp] = sr;
        part_i[j][warp] = si;
      }
    }
    __syncthreads();
    for (int j = tid; j < nl; j += nt) {
      T sr = T(0), si = T(0);
      for (int w = 0; w < nwarp; ++w) {
        sr += part_r[j][w];
        si += part_i[j][w];
      }
      const size_t out = static_cast<size_t>(l0 + j) * L + m;
      Ar[out] = sr;
      Ai[out] = si;
    }
    __syncthreads();
  }
}

template <typename T, int RPT>
__global__ void __launch_bounds__(kMaxThreads)
legendre_synth_kernel(const T* __restrict__ ar, const T* __restrict__ ai,
                      const T* __restrict__ pmm, const T* __restrict__ xs,
                      const int32_t* __restrict__ sc0, T* __restrict__ Ber,
                      T* __restrict__ Bor, T* __restrict__ Bei,
                      T* __restrict__ Boi, int L, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_r = reinterpret_cast<T*>(smem_raw);  // a[l, m] for l in [m, L)
  T* a_i = a_r + L;
  const int m = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row = static_cast<size_t>(m) * R;
  for (int l = m + tid; l < L; l += nt) {
    a_r[l] = ar[static_cast<size_t>(l) * L + m];
    a_i[l] = ai[static_cast<size_t>(l) * L + m];
  }

  T x[RPT], p1[RPT], p2[RPT], ber[RPT], bor[RPT], bei[RPT], boi[RPT];
  int sc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = tid + k * nt;
    x[k] = r < R ? xs[r] : T(0);
    p1[k] = p2[k] = ber[k] = bor[k] = bei[k] = boi[k] = T(0);
    sc[k] = 0;
  }
  __syncthreads();

  for (int l = m; l < L; ++l) {
    const bool seed = (l == m);
    const bool even = ((l + m) & 1) == 0;
    T al, inv_al1;
    factors(l, m, &al, &inv_al1);
    const T cr = a_r[l], ci = a_i[l];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = tid + k * nt;
      T seed_p = T(0);
      int seed_sc = 0;
      if (seed && r < R) {
        seed_p = pmm[row + r];
        seed_sc = sc0[row + r];
      }
      const T lam = step(seed, seed_p, seed_sc, x[k], al, inv_al1, p1[k],
                         p2[k], sc[k]);
      if (even) {
        ber[k] += cr * lam;
        bei[k] += ci * lam;
      } else {
        bor[k] += cr * lam;
        boi[k] += ci * lam;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = tid + k * nt;
    if (r < R) {
      Ber[row + r] = ber[k];
      Bor[row + r] = bor[k];
      Bei[row + r] = bei[k];
      Boi[row + r] = boi[k];
    }
  }
}

// RPT = rings per thread: the smallest power of two with R <= 256 * RPT;
// then as many threads (a multiple of 32) as the rings need.
inline int rings_per_thread(int R) {
  int rpt = 1;
  while (rpt * kMaxThreads < R) rpt *= 2;
  return rpt;
}

inline int threads_for(int R, int rpt) {
  const int t = (R + rpt - 1) / rpt;
  return ((t + 31) / 32) * 32;
}

template <typename T>
int launch_alm(const T* Ger, const T* Gor, const T* Gei, const T* Goi,
               const T* pmm, const T* x, const int32_t* sc0, T* Ar, T* Ai,
               int L, int R, cudaStream_t stream) {
  if (L < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rpt = rings_per_thread(R);
  const dim3 grid(L), block(threads_for(R, rpt));
#define BT_ALM(N)                                                         \
  case N:                                                                 \
    legendre_alm_kernel<T, N><<<grid, block, 0, stream>>>(                \
        Ger, Gor, Gei, Goi, pmm, x, sc0, Ar, Ai, L, R);                   \
    break;
  switch (rpt) {
    BT_ALM(1) BT_ALM(2) BT_ALM(4) BT_ALM(8) BT_ALM(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BT_ALM
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RPT>
int launch_synth_rpt(const T* ar, const T* ai, const T* pmm, const T* x,
                     const int32_t* sc0, T* Ber, T* Bor, T* Bei, T* Boi,
                     int L, int R, int threads, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(L) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        legendre_synth_kernel<T, RPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  legendre_synth_kernel<T, RPT><<<L, threads, smem, stream>>>(
      ar, ai, pmm, x, sc0, Ber, Bor, Bei, Boi, L, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_synth(const T* ar, const T* ai, const T* pmm, const T* x,
                 const int32_t* sc0, T* Ber, T* Bor, T* Bei, T* Boi, int L,
                 int R, cudaStream_t stream) {
  if (L < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rpt = rings_per_thread(R);
  const int threads = threads_for(R, rpt);
#define BT_SYN(N)                                                         \
  case N:                                                                 \
    return launch_synth_rpt<T, N>(ar, ai, pmm, x, sc0, Ber, Bor, Bei, Boi, \
                                  L, R, threads, stream);
  switch (rpt) {
    BT_SYN(1) BT_SYN(2) BT_SYN(4) BT_SYN(8) BT_SYN(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BT_SYN
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors; sc0 is int32. Returns the CUDA error of the launch
// (0 on success); the launch is asynchronous on `stream`.
#define BT_EXPORT(S, T)                                                    \
  extern "C" int legendre_alm_##S(                                         \
      const void* Ger, const void* Gor, const void* Gei, const void* Goi,  \
      const void* pmm, const void* x, const void* sc0, void* Ar,           \
      void* Ai, int L, int R, void* stream) {                              \
    return launch_alm<T>(                                                  \
        static_cast<const T*>(Ger), static_cast<const T*>(Gor),            \
        static_cast<const T*>(Gei), static_cast<const T*>(Goi),            \
        static_cast<const T*>(pmm), static_cast<const T*>(x),              \
        static_cast<const int32_t*>(sc0), static_cast<T*>(Ar),             \
        static_cast<T*>(Ai), L, R, static_cast<cudaStream_t>(stream));     \
  }                                                                        \
  extern "C" int legendre_synth_##S(                                       \
      const void* ar, const void* ai, const void* pmm, const void* x,      \
      const void* sc0, void* Ber, void* Bor, void* Bei, void* Boi, int L,  \
      int R, void* stream) {                                               \
    return launch_synth<T>(                                                \
        static_cast<const T*>(ar), static_cast<const T*>(ai),              \
        static_cast<const T*>(pmm), static_cast<const T*>(x),              \
        static_cast<const int32_t*>(sc0), static_cast<T*>(Ber),            \
        static_cast<T*>(Bor), static_cast<T*>(Bei), static_cast<T*>(Boi),  \
        L, R, static_cast<cudaStream_t>(stream));                          \
  }

BT_EXPORT(f32, float)
BT_EXPORT(f64, double)
