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
//   - synthesis: no sum across threads, so one barrier after the set-up
//     and none after it. The set-up packs, for every step l of the row,
//     al(l), 1 / al(l - 1), a_r[l, m] and a_i[l, m] side by side in shared
//     memory (each factor computed once): a step reads them in one
//     16-byte broadcast load (two in double), issued half a pair of steps
//     ahead. Each thread keeps its rings' four fold sums in registers and
//     writes [m, r] once at the end. A warp's slot k is 32 neighbouring
//     rings, k = 0 at the pole. Every kSynthChunk steps each warp alone
//     votes on its slots and runs the version of the chunk loop that fits
//     them (at most 9): slots out of the scaled regime run the bare
//     recurrence and the two sums (6 arithmetic instructions an update);
//     slots that may still rescale only take the largest |p| of their
//     rings, and the exact rescale code sits behind one branch that the
//     warp takes as one (a vote), with lambda = p & lit for a per-ring
//     mask. A ring rescales once in ~30 steps, but a warp holds up to 256
//     scaled rings, so most steps of a tested slot do take the branch.
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
// Synthesis, the same loop: 103 instructions (6.4 an update) in slots out
// of the scaled regime, 142 (8.9) in tested slots at a step where no ring
// of the warp rescales and 254 (15.9) where one does; in double 105, 169
// and 320, of which 96, 96 and 144 FP64. With chunks of 64 steps 67% (f32)
// and 70% (f64) of the updates run out of the scaled regime, 25% and 18%
// tested at a step where their warp rescales.
// Registers (ptxas -v, CUDA 12.8), 8 rings a thread: analysis 114 (f32) and
// 161 (f64), synthesis 96 and 166, none spilled. Only the double kernels
// at 16 rings a thread (NSIDE 2048) spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the most; the analysis always runs these
constexpr int kTile = 32;  // ell steps per shared-memory tile (analysis)
// The synthesis: ell steps between two votes of a warp on its slots, an
// even number (legendre_synth_chunk() reports it).
constexpr int kSynthChunk = 64;
static_assert(kSynthChunk > 0 && kSynthChunk % 2 == 0, "steps run in pairs");

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

// ---- synthesis ----

// The largest |p| of a step's tested rings, so that one compare a step
// says whether any ring may rescale. In float it is |p| itself (one
// FMNMX a ring). In double it is the high word of |p|, kept on the integer
// pipe and off the FP64 one: the compare is then true for every |p| > BIG
// (and for NaN and inf), and for a few |p| just below BIG, which the exact
// test that follows sorts out.
template <typename T>
struct Peak;
template <>
struct Peak<float> {
  float v = 0.0f;
  __device__ __forceinline__ void add(float p) { v = fmaxf(v, fabsf(p)); }
  __device__ __forceinline__ bool maybe_big() const {
    return v > Scaling<float>::big();
  }
};
template <>
struct Peak<double> {
  int v = 0;
  __device__ __forceinline__ void add(double p) {
    v = max(v, __double2hiint(p) & 0x7fffffff);
  }
  __device__ __forceinline__ bool maybe_big() const {
    return v >= __double2hiint(Scaling<double>::big());
  }
};
// p where lit is all ones, +0 where it is 0 (a bitwise and, no FP64 pipe)
__device__ __forceinline__ float keep_if(float p, int lit) {
  return __int_as_float(__float_as_int(p) & lit);
}
__device__ __forceinline__ double keep_if(double p, int lit) {
  return __hiloint2double(__double2hiint(p) & lit, __double2loint(p) & lit);
}

// The four scalars of step l for row m, side by side in shared memory so
// that one 16-byte load (two in double) brings them: al(l), 1 / al(l - 1),
// a_r[l, m], a_i[l, m].
template <typename T>
__device__ __forceinline__ void load_step_row(const T* row, T (&f)[4]);
template <>
__device__ __forceinline__ void load_step_row<float>(const float* row,
                                                     float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
template <>
__device__ __forceinline__ void load_step_row<double>(const double* row,
                                                      double (&f)[4]) {
  const double2 u = *reinterpret_cast<const double2*>(row);
  const double2 v = *reinterpret_cast<const double2*>(row + 2);
  f[0] = u.x, f[1] = u.y, f[2] = v.x, f[3] = v.y;
}

// One step of the synthesis for the RPT rings of one thread: the
// recurrence and the two sums of this step's parity. f is the step's row
// of the table. The thread's slots are of two kinds, fixed for a chunk of
// steps by the warp's vote:
//   k >= K0  every ring has sc == 0: no rescale can fire and lambda is p,
//            so an update is the recurrence and the two sums;
//   k < K0   rings may rescale. That is rare (once in many steps), so the
//            step only keeps the largest |p| of these rings (see Peak), and
//            the exact per-ring code of the scan body (grow, the two
//            products by 1/FOLD, the counter) runs behind one branch that
//            a warp takes when any of its rings may rescale.
//            lit[k] is all ones once sc[k] == 0, else 0: lambda is
//            p & lit.
template <typename T, int RPT, int K0>
__device__ __forceinline__ void synth_step(const T (&f)[4], const T (&x)[RPT],
                                           T (&p1)[RPT], T (&p2)[RPT],
                                           int (&sc)[RPT], int (&lit)[RPT],
                                           T (&sr)[RPT], T (&si)[RPT]) {
  const T al = f[0], inv_al1 = f[1], cr = f[2], ci = f[3];
  T p[RPT];
  Peak<T> peak;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    p[k] = mul_rn(al, sub_rn(mul_rn(x[k], p1[k]), mul_rn(p2[k], inv_al1)));
    if (k < K0) peak.add(p[k]);
  }
  // the vote makes the branch uniform: the warp takes it as one, with no
  // divergence to manage
  if (K0 > 0 && __any_sync(0xffffffffu, peak.maybe_big())) {
#pragma unroll
    for (int k = 0; k < K0; ++k) {
      if (bt_abs(p[k]) > Scaling<T>::big() && sc[k] > 0) {
        p[k] = mul_rn(p[k], Scaling<T>::inv_fold());
        p1[k] = mul_rn(p1[k], Scaling<T>::inv_fold());  // the next p2
        if (--sc[k] == 0) lit[k] = -1;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    p2[k] = p1[k];
    p1[k] = p[k];
    const T lam = k < K0 ? keep_if(p[k], lit[k]) : p[k];
    sr[k] += cr * lam;
    si[k] += ci * lam;
  }
}

// Steps l, l + 1 (odd, then even parity of l + m: every chunk starts at an
// odd l - m) while both lie below lend; returns the first step not done.
// Each row of the table is loaded half a pair ahead of its step, so that
// the load's latency lies under the other step's arithmetic; the last
// load of a chunk reads the row after it (row L is padding).
template <typename T, int RPT, int K0>
__device__ __forceinline__ int synth_pairs(
    int l, int lend, const T* tab, const T (&x)[RPT], T (&p1)[RPT],
    T (&p2)[RPT], int (&sc)[RPT], int (&lit)[RPT], T (&ber)[RPT],
    T (&bor)[RPT], T (&bei)[RPT], T (&boi)[RPT]) {
  T f_odd[4], f_even[4];
  load_step_row<T>(tab + 4 * l, f_odd);
  for (; l + 1 < lend; l += 2) {
    load_step_row<T>(tab + 4 * (l + 1), f_even);
    synth_step<T, RPT, K0>(f_odd, x, p1, p2, sc, lit, bor, boi);
    load_step_row<T>(tab + 4 * (l + 2), f_odd);
    synth_step<T, RPT, K0>(f_even, x, p1, p2, sc, lit, ber, bei);
  }
  return l;
}

template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads, (RPT * sizeof(T) <= 32 ? 2 : 1))
legendre_synth_kernel(const T* __restrict__ ar, const T* __restrict__ ai,
                      const T* __restrict__ pmm, const T* __restrict__ xs,
                      const int32_t* __restrict__ sc0, T* __restrict__ Ber,
                      T* __restrict__ Bor, T* __restrict__ Bei,
                      T* __restrict__ Boi, int L, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // rows [L + 1][4], row l: al(l), 1 / al(l - 1), a_r[l, m], a_i[l, m];
  // row L is padding that synth_pairs may load and never uses
  T* tab = reinterpret_cast<T*>(smem_raw);
  const int m = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row = static_cast<size_t>(m) * R;
  for (int l = m + tid; l < L; l += nt) {
    const T al = al_factor<T>(l, m);
    tab[4 * l] = al;
    if (l + 1 < L) tab[4 * (l + 1) + 1] = static_cast<T>(1) / al;
    tab[4 * l + 2] = ar[static_cast<size_t>(l) * L + m];
    tab[4 * l + 3] = ai[static_cast<size_t>(l) * L + m];
  }
  __syncthreads();  // the only barrier: from here the warps run free

  // Slot k of a warp is the 32 neighbouring rings tid + k * nt, from the
  // pole (k = 0) to the equator; rings beyond R hold zeros and sc == 0.
  // The seed step l = m has even parity.
  T x[RPT], p1[RPT], p2[RPT], ber[RPT], bor[RPT], bei[RPT], boi[RPT];
  int sc[RPT], lit[RPT];
  {
    const T cr = tab[4 * m + 2], ci = tab[4 * m + 3];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = tid + k * nt;
      const bool in = r < R;
      x[k] = in ? xs[r] : T(0);
      const T lam = seed_step<T>(in ? pmm[row + r] : T(0),
                                 in ? sc0[row + r] : 0, p1[k], p2[k], sc[k]);
      lit[k] = sc[k] == 0 ? -1 : 0;
      ber[k] = cr * lam;
      bei[k] = ci * lam;
      bor[k] = boi[k] = T(0);
    }
  }

  // The ell loop in chunks of kSynthChunk steps. At the start of a chunk
  // each warp alone votes on its slots: sc never rises, so a slot whose 32
  // rings all have sc == 0 stays so, and k0, the slots from the pole that
  // may still rescale, only falls (a warp with k0 == 0 votes no more).
  // Slots leave in groups of kGroup, so the chunk loop exists in at most 9
  // versions.
  constexpr int kGroup = RPT <= 8 ? 1 : RPT / 8;
  int k0 = RPT;
  for (int l0 = m + 1; l0 < L; l0 += kSynthChunk) {
    const int lend = min(l0 + kSynthChunk, L);
    if (k0 > 0) {
      int still = 0;
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        if (!__all_sync(0xffffffffu, sc[k] == 0)) still = k + 1;
      k0 = still;
    }
    int l = l0;
#define BT_CHUNK(Q)                                                          \
  case Q:                                                                    \
    if constexpr (Q * kGroup <= RPT)                                         \
      l = synth_pairs<T, RPT, (Q * kGroup <= RPT ? Q * kGroup : RPT)>(       \
          l, lend, tab, x, p1, p2, sc, lit, ber, bor, bei, boi);             \
    break;
    switch ((k0 + kGroup - 1) / kGroup) {
      BT_CHUNK(0) BT_CHUNK(1) BT_CHUNK(2) BT_CHUNK(3) BT_CHUNK(4)
      BT_CHUNK(5) BT_CHUNK(6) BT_CHUNK(7) BT_CHUNK(8)
    }
#undef BT_CHUNK
    if (l < lend) {  // an odd count of steps ends on an odd-parity step
      T f[4];
      load_step_row<T>(tab + 4 * l, f);
      synth_step<T, RPT, RPT>(f, x, p1, p2, sc, lit, bor, boi);
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
  // the table of step rows, one of padding
  const size_t smem = 4 * static_cast<size_t>(L + 1) * sizeof(T);
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

// The synthesis kernel's chunk length, for whoever models its control flow.
extern "C" int legendre_synth_chunk() { return kSynthChunk; }
