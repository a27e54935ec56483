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
// first and the tail is short. The threads share the R rings, RPT rings
// each, with x, the inputs, p1, p2 and sc held in registers for the whole
// loop: nothing but the results goes back to device memory. (The TPU
// kernel blocks MB rows of m and keeps the carries in VMEM instead; its
// one-hot lane tricks exist for Mosaic layouts and are not carried over.)
// What a step costs is instructions, so the design removes them:
//   - the factors al(l), 1 / al(l - 1) depend on (l, m) only. One thread
//     a step computes them (sqrt, division, reciprocal) into shared
//     memory, the analysis for a tile of kTile steps, the synthesis for
//     its whole row, and all threads read them as broadcasts;
//   - the seed step l = m is peeled off, and the steps after it run in
//     pairs, so the parity of l + m is static and a step reads one pair
//     of folds;
//   - analysis, the sum over rings: a thread stores its partial sums of
//     a step to a shared [kTile][threads] tile (two stores a step, no
//     shuffles), and once a tile the CTA sums the tile's rows with
//     16-byte loads. Two barriers a tile. The wrapper zeroes A, so the
//     m > l triangle stays zero;
//   - analysis, the rescale test: once a ring's counter sc is 0 it stays
//     0, no rescale can fire and lambda is p itself, so four of a
//     step's instructions remain. A warp holds slots of 32 neighbouring
//     rings spread from the pole to the equator; at the start of a tile
//     it votes which of its slots are out of the scaled regime and runs
//     the version of the tile loop that tests only the others (at most 9
//     versions). All warps of a CTA hold a like mix, so they reach the
//     barrier together;
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
// 3.35 TB/s. That rate needs fused multiply-adds; the recurrence is three
// rounded multiplies and a subtract (see mul_rn), so what bounds these
// kernels is instruction issue. Analysis, sm_90a SASS of the loop over one
// even and one odd step of 8 rings: 111 instructions (6.9 an update) where
// no ring tests for the rescale, 246 (15.4) where all do; in double 112
// (96 of them FP64, which hold their pipe two clocks) and 321 (144). On
// the NSIDE-1024 seeds 68% (f32) and 70% (f64) of the updates run untested.
// Registers (ptxas -v, CUDA 12.8), 8 rings a thread: analysis 114 (f32) and
// 161 (f64), synthesis 96 and 156, none spilled. Only the double kernels
// at 16 rings a thread (NSIDE 2048) spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the most; the analysis always runs these
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

// The recurrence factor of step l for row m, computed in T exactly as the
// JAX package does (factored (l-m)(l+m) form; the clamps only bite where
// the seed or p2 == 0 discards the result). Step l multiplies by al(l)
// and by 1 / al(l - 1): the package's second factor al1(l) is the same
// expression one step earlier, on operands that are exact integers in T,
// so al1(l) and al(l - 1) have the same bits.
template <typename T>
__device__ __forceinline__ T al_factor(int l, int m) {
  const T lf = static_cast<T>(l), mf = static_cast<T>(m);
  const T half = static_cast<T>(0.5);
  return bt_sqrt(bt_max((2 * lf - 1) * (2 * lf + 1), half) /
                 bt_max((lf - mf) * (lf + mf), half));
}

// The seed step l = m for one ring; returns lambda (0 while still scaled).
template <typename T>
__device__ __forceinline__ T seed_step(T seed_p, int seed_sc, T& p1, T& p2,
                                       int& sc) {
  const bool grow = (bt_abs(seed_p) > Scaling<T>::big()) && (seed_sc > 0);
  p1 = grow ? mul_rn(seed_p, Scaling<T>::inv_fold()) : seed_p;
  p2 = static_cast<T>(0);
  sc = seed_sc - (grow ? 1 : 0);
  return sc == 0 ? p1 : static_cast<T>(0);
}

// One scaled step l > m for one ring; returns lambda (0 while still
// scaled). With FAST the caller knows sc == 0: no rescale can fire (it
// needs sc > 0) and lambda is p itself, so the same bits come out of
// four instructions.
template <typename T, bool FAST>
__device__ __forceinline__ T step(T x, T al, T inv_al1, T& p1, T& p2,
                                  int& sc) {
  T p = mul_rn(al, sub_rn(mul_rn(x, p1), mul_rn(p2, inv_al1)));
  if (FAST) {
    p2 = p1;
    p1 = p;
    return p;
  }
  const bool grow = (bt_abs(p) > Scaling<T>::big()) && (sc > 0);
  if (grow) p = mul_rn(p, Scaling<T>::inv_fold());
  p2 = grow ? mul_rn(p1, Scaling<T>::inv_fold()) : p1;
  sc -= grow ? 1 : 0;
  p1 = p;
  return sc == 0 ? p : static_cast<T>(0);
}

// Step l of the analysis for the RPT rings of one thread: the recurrence,
// and the thread's partial sums of lambda * G over its rings, stored to
// the tile row of this step. gr/gi are the folds of this step's parity.
// Rings k >= K0 are known to be out of the scaled regime (see step()).
template <typename T, int RPT, int K0>
__device__ __forceinline__ void alm_step(T al, T inv_al1, const T (&x)[RPT],
                                         const T (&gr)[RPT],
                                         const T (&gi)[RPT], T (&p1)[RPT],
                                         T (&p2)[RPT], int (&sc)[RPT],
                                         T* out_r, T* out_i) {
  T sr = T(0), si = T(0);
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const T lam = k < K0
        ? step<T, false>(x[k], al, inv_al1, p1[k], p2[k], sc[k])
        : step<T, true>(x[k], al, inv_al1, p1[k], p2[k], sc[k]);
    sr += gr[k] * lam;
    si += gi[k] * lam;
  }
  *out_r = sr;
  *out_i = si;
}

// Steps j, j + 1 (even, then odd parity of l + m: every tile starts at an
// even l - m) while both lie below nl; returns the first step not done.
// f_al[i] = al(l0 - 1 + i), f_inv[i] = 1 / f_al[i]; tile rows are kThreads
// apart.
template <typename T, int RPT, int K0>
__device__ __forceinline__ int alm_pairs(
    int j, int nl, const T* f_al, const T* f_inv, const T (&x)[RPT],
    const T (&ger)[RPT], const T (&gor)[RPT], const T (&gei)[RPT],
    const T (&goi)[RPT], T (&p1)[RPT], T (&p2)[RPT], int (&sc)[RPT],
    T* part_r, T* part_i) {
  for (; j + 1 < nl; j += 2) {
    alm_step<T, RPT, K0>(f_al[j + 1], f_inv[j], x, ger, gei, p1, p2, sc,
                         part_r + j * kThreads, part_i + j * kThreads);
    alm_step<T, RPT, K0>(f_al[j + 2], f_inv[j + 1], x, gor, goi, p1, p2, sc,
                         part_r + (j + 1) * kThreads,
                         part_i + (j + 1) * kThreads);
  }
  return j;
}

// 16 bytes of T: the unit of the tile reduction's shared-memory loads
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  typedef float4 type;
  static __device__ __forceinline__ float sum(float4 v) {
    return (v.x + v.y) + (v.z + v.w);
  }
};
template <>
struct Vec16<double> {
  typedef double2 type;
  static __device__ __forceinline__ double sum(double2 v) { return v.x + v.y; }
};

// Two CTAs per SM where the per-ring state leaves room for them (float up
// to 8 rings per thread, double up to 4), so that while one CTA's warps
// wait at a barrier the other's issue.
template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads, (RPT * sizeof(T) <= 32 ? 2 : 1))
legendre_alm_kernel(const T* __restrict__ Ger, const T* __restrict__ Gor,
                    const T* __restrict__ Gei, const T* __restrict__ Goi,
                    const T* __restrict__ pmm, const T* __restrict__ xs,
                    const int32_t* __restrict__ sc0, T* __restrict__ Ar,
                    T* __restrict__ Ai, int L, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kWarps = kThreads / 32;
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // per-thread partial sums of one tile: rows [2 * kTile][kThreads], the
  // kTile re rows, then the kTile im rows
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* part_r = tile + tid;
  T* part_i = part_r + kTile * kThreads;
  __shared__ T f_al[kTile + 1];
  __shared__ T f_inv[kTile + 1];
  const size_t row = static_cast<size_t>(m) * R;

  // The rings go to the threads in slots of 32 neighbours: slot k of
  // warp w is rings 32 * (k * kWarps + w) + lane. Every warp so holds a
  // like mix from the pole (k = 0) to the equator, the warps of a CTA
  // reach the barrier together, and inside a warp the slots leave the
  // scaled regime from the highest k down. Rings beyond R hold zeros: no
  // seed, no G, so they contribute nothing. The seed step l = m (even
  // parity) fills row 0 of the first tile.
  T x[RPT], ger[RPT], gor[RPT], gei[RPT], goi[RPT], p1[RPT], p2[RPT];
  int sc[RPT];
  {
    T sr = T(0), si = T(0);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = (k * kWarps + warp) * 32 + lane;
      const bool in = r < R;
      x[k] = in ? xs[r] : T(0);
      ger[k] = in ? Ger[row + r] : T(0);
      gor[k] = in ? Gor[row + r] : T(0);
      gei[k] = in ? Gei[row + r] : T(0);
      goi[k] = in ? Goi[row + r] : T(0);
      const T lam = seed_step<T>(in ? pmm[row + r] : T(0),
                                 in ? sc0[row + r] : 0, p1[k], p2[k], sc[k]);
      sr += ger[k] * lam;
      si += gei[k] * lam;
    }
    *part_r = sr;
    *part_i = si;
  }

  // slots are released from the scaled code in groups of kGroup, so the
  // tile loop exists in at most 9 versions
  constexpr int kGroup = RPT <= 8 ? 1 : RPT / 8;
  for (int l0 = m; l0 < L; l0 += kTile) {
    const int nl = min(kTile, L - l0);
    // the tile's factors, one thread per step; the barrier also ends the
    // previous tile's reads of the partial sums
    if (tid <= kTile) {
      const T al = al_factor<T>(l0 - 1 + tid, m);
      f_al[tid] = al;
      f_inv[tid] = static_cast<T>(1) / al;
    }
    // sc never rises, so a slot whose 32 rings all have sc == 0 stays so;
    // k0 = slots, from the pole, that still run the scaled code
    int k0 = 0;
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (!__all_sync(0xffffffffu, sc[k] == 0)) k0 = k + 1;
    __syncthreads();
    int j = 0;
    if (l0 == m) {  // row 0 is the seed's; step 1 has odd parity
      if (nl > 1)
        alm_step<T, RPT, RPT>(f_al[2], f_inv[1], x, gor, goi, p1, p2, sc,
                              part_r + kThreads, part_i + kThreads);
      j = 2;
    }
#define BT_PAIRS(Q)                                                          \
  case Q:                                                                    \
    if constexpr (Q * kGroup <= RPT)                                         \
      j = alm_pairs<T, RPT, (Q * kGroup <= RPT ? Q * kGroup : RPT)>(         \
          j, nl, f_al, f_inv, x, ger, gor, gei, goi, p1, p2, sc, part_r,     \
          part_i);                                                           \
    break;
    switch ((k0 + kGroup - 1) / kGroup) {
      BT_PAIRS(0) BT_PAIRS(1) BT_PAIRS(2) BT_PAIRS(3) BT_PAIRS(4)
      BT_PAIRS(5) BT_PAIRS(6) BT_PAIRS(7) BT_PAIRS(8)
    }
#undef BT_PAIRS
    if (j < nl)  // an odd count of steps ends on an even-parity step
      alm_step<T, RPT, RPT>(f_al[j + 1], f_inv[j], x, ger, gei, p1, p2, sc,
                            part_r + j * kThreads, part_i + j * kThreads);
    __syncthreads();
    // The sum over threads: 4 threads a tile row, each adds a quarter row
    // in 16-byte loads (rotated by the lane, so the 8 lanes of a load
    // phase hit 8 different banks), then two shuffles join the quarters.
    {
      static_assert(kThreads == 8 * kTile, "4 threads a tile row");
      typedef typename Vec16<T>::type V;
      constexpr int kVecs = kThreads / 4 * sizeof(T) / 16;  // a quarter row
      const int q = tid >> 2;  // tile row: re of step q, or im of q - kTile
      const V* src = reinterpret_cast<const V*>(tile + q * kThreads) +
                     (tid & 3) * kVecs;
      T s = T(0);
#pragma unroll
      for (int i = 0; i < kVecs; ++i)
        s += Vec16<T>::sum(src[(i + lane) & (kVecs - 1)]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int jq = q & (kTile - 1);
      if ((tid & 3) == 0 && jq < nl)
        (q < kTile ? Ar : Ai)[static_cast<size_t>(l0 + jq) * L + m] = s;
    }
  }
}

template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads, (RPT * sizeof(T) <= 32 ? 2 : 1))
legendre_synth_kernel(const T* __restrict__ ar, const T* __restrict__ ai,
                      const T* __restrict__ pmm, const T* __restrict__ xs,
                      const int32_t* __restrict__ sc0, T* __restrict__ Ber,
                      T* __restrict__ Bor, T* __restrict__ Bei,
                      T* __restrict__ Boi, int L, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // for l in [m, L): a[l, m] and the two factors of step l
  T* a_r = reinterpret_cast<T*>(smem_raw);
  T* a_i = a_r + L;
  T* f_al = a_i + L;
  T* f_inv = f_al + L;
  const int m = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row = static_cast<size_t>(m) * R;
  for (int l = m + tid; l < L; l += nt) {
    a_r[l] = ar[static_cast<size_t>(l) * L + m];
    a_i[l] = ai[static_cast<size_t>(l) * L + m];
    f_al[l] = al_factor<T>(l, m);
    f_inv[l] = static_cast<T>(1) / al_factor<T>(l - 1, m);
  }
  __syncthreads();

  // the seed step l = m (even parity), then odd and even steps in pairs
  T x[RPT], p1[RPT], p2[RPT], ber[RPT], bor[RPT], bei[RPT], boi[RPT];
  int sc[RPT];
  {
    const T cr = a_r[m], ci = a_i[m];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = tid + k * nt;
      const bool in = r < R;
      x[k] = in ? xs[r] : T(0);
      const T lam = seed_step<T>(in ? pmm[row + r] : T(0),
                                 in ? sc0[row + r] : 0, p1[k], p2[k], sc[k]);
      ber[k] = cr * lam;
      bei[k] = ci * lam;
      bor[k] = boi[k] = T(0);
    }
  }
  for (int l = m + 1; l < L; l += 2) {
    {
      const T al = f_al[l], inv_al1 = f_inv[l];
      const T cr = a_r[l], ci = a_i[l];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const T lam = step<T, false>(x[k], al, inv_al1, p1[k], p2[k], sc[k]);
        bor[k] += cr * lam;
        boi[k] += ci * lam;
      }
    }
    if (l + 1 < L) {
      const T al = f_al[l + 1], inv_al1 = f_inv[l + 1];
      const T cr = a_r[l + 1], ci = a_i[l + 1];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const T lam = step<T, false>(x[k], al, inv_al1, p1[k], p2[k], sc[k]);
        ber[k] += cr * lam;
        bei[k] += ci * lam;
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

// RPT = rings per thread: the smallest power of two with R <= 256 * RPT.
// The analysis always runs 256 threads (its tile reduction is laid out
// for them); the synthesis as many (a multiple of 32) as the rings need.
inline int rings_per_thread(int R) {
  int rpt = 1;
  while (rpt * kThreads < R) rpt *= 2;
  return rpt;
}

inline int threads_for(int R, int rpt) {
  const int t = (R + rpt - 1) / rpt;
  return ((t + 31) / 32) * 32;
}

template <typename T, int RPT>
int launch_alm_rpt(const T* Ger, const T* Gor, const T* Gei, const T* Goi,
                   const T* pmm, const T* x, const int32_t* sc0, T* Ar,
                   T* Ai, int L, int R, cudaStream_t stream) {
  // the tile of partial sums: 64 KB in float, 128 KB in double
  const size_t smem = 2 * static_cast<size_t>(kTile) * kThreads * sizeof(T);
  const cudaError_t e = cudaFuncSetAttribute(
      legendre_alm_kernel<T, RPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  legendre_alm_kernel<T, RPT><<<L, kThreads, smem, stream>>>(
      Ger, Gor, Gei, Goi, pmm, x, sc0, Ar, Ai, L, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_alm(const T* Ger, const T* Gor, const T* Gei, const T* Goi,
               const T* pmm, const T* x, const int32_t* sc0, T* Ar, T* Ai,
               int L, int R, cudaStream_t stream) {
  if (L < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rpt = rings_per_thread(R);
#define BT_ALM(N)                                                          \
  case N:                                                                  \
    return launch_alm_rpt<T, N>(Ger, Gor, Gei, Goi, pmm, x, sc0, Ar, Ai,   \
                                L, R, stream);
  switch (rpt) {
    BT_ALM(1) BT_ALM(2) BT_ALM(4) BT_ALM(8) BT_ALM(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BT_ALM
}

template <typename T, int RPT>
int launch_synth_rpt(const T* ar, const T* ai, const T* pmm, const T* x,
                     const int32_t* sc0, T* Ber, T* Bor, T* Bei, T* Boi,
                     int L, int R, int threads, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(L) * sizeof(T);
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
