// Variants of the shell regrid kernel, for splitting its time on the card
// (experiments/regrid/split.py builds and runs them). They include the
// package's source of the checkout being measured (-I <checkout>/
// baryonification_tpu_torch), so they run its device code as it stands;
// REGRID_TABLE is defined for a source with the ring table (this PR's),
// not for its parent's:
//
// - regrid_compute: the corners of every pixel (ids, weights, the four
//   products) and no add; each thread folds them into a checksum that it
//   writes only where it takes an impossible value, so nothing is
//   eliminated and nothing is stored;
// - regrid_adds: the adds alone, one red.global.add a nonzero row, fed
//   each pixel's four ids (int32) and values w_k m (the check entry's
//   rows, laid out k-major: row k of pixel i at k n + i);
// - regrid_adds_match: the same rows, lanes of a warp with the same id in
//   the same corner k merged (__match_any_sync and a tree of shuffles);
// - regrid_adds_table: the same rows, a warp's 128 merged by destination
//   across the four corners through a table in shared memory (the merge
//   measured first, merge_rows_hash below);
// - regrid_adds_parity: the same rows merged by the package's merge_rows
//   (four rounds of __match_any_sync; this PR's source only), fed each
//   pixel's first ring;
// - regrid_rows: one red.global.add a row of a list that holds each
//   (warp, destination) once: the adds of a perfect merge.

#include "csrc/regrid.cu"

namespace {

constexpr unsigned kAll = 0xffffffffu;

#ifdef REGRID_TABLE
using Id = int;
template <typename T>
using RingPtr = const Ring<T>*;
#define CORNERS(in, rings, i, nside, p, w, tm) \
  load_corners(in, rings, i, nside, p, w, tm)
#else
using Id = long long;
template <typename T>
using RingPtr = const void*;
#define CORNERS(in, rings, i, nside, p, w, tm) \
  load_corners(in, i, nside, p, w, tm)

#endif

// the merge measured first: a warp's rows merged by destination through
// a table in shared memory (kept here; the package took the four-round
// match merge instead): each nonzero row claims its destination's slot
// (integer atomicCAS, the next slot on a clash) and links itself in front
// of the slot's list (atomicExch of the head); after the warp's barrier
// the row at each list's head sums the list and adds it with one
// red.global.add
template <typename T>
struct HashTable {
  int key[256];
  int head[256];
  int next[128];
  T val[128];
};

template <typename T>
__device__ __forceinline__ int merge_rows_hash(HashTable<T>& tb, const int p[4],
                                          const T v[4], T* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = lane; s < 256; s += 32) {
    tb.key[s] = -1;
    tb.head[s] = -1;
  }
  __syncwarp();
  int slot[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    slot[k] = -1;
    if (v[k] != T(0)) {
      int h = static_cast<int>((static_cast<unsigned>(p[k]) * 2654435761u) >>
                               24);
      int old = atomicCAS(&tb.key[h], -1, p[k]);
      while (old != -1 && old != p[k]) {
        h = (h + 1) & 255;
        old = atomicCAS(&tb.key[h], -1, p[k]);
      }
      const int r = k * 32 + lane;
      tb.val[r] = v[k];
      tb.next[r] = atomicExch(&tb.head[h], r);
      slot[k] = h;
    }
  }
  __syncwarp();
  int adds = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = k * 32 + lane;
    if (slot[k] >= 0 && tb.head[slot[k]] == r) {
      T s = tb.val[r];
      for (int q = tb.next[r]; q >= 0; q = tb.next[q]) s += tb.val[q];
      atomicAdd(out + p[k], s);
      ++adds;
    }
  }
  __syncwarp();
  return adds;
}
template <typename T>
__global__ void __launch_bounds__(kThreads)
compute_kernel(In<T> in, RingPtr<T> rings, int nside, long long n_in,
               T* __restrict__ sink) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_in) return;
  const T m = in.m[i];
  Id p[4];
  T w[4];
  Terms<T> tm;
  CORNERS(in, rings, i, nside, p, w, tm);
  const T s = (w[0] * m + w[1] * m) + (w[2] * m + w[3] * m);
  const Id h = (p[0] ^ p[1]) ^ (p[2] ^ p[3]);
  if (s == T(-12345) || h == -7) sink[i] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adds_kernel(const int* __restrict__ ids, const T* __restrict__ vals,
            long long n_in, T* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_in) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T v = vals[k * n_in + i];
    if (v != T(0)) atomicAdd(out + ids[k * n_in + i], v);
  }
}

// the sum of the peers' v into the lowest peer (every lane calls it)
template <typename T>
__device__ __forceinline__ T reduce_peers(unsigned peers, T v) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);
  while (__any_sync(kAll, rest != 0)) {
    const int next = __ffs(rest);
    const T t = __shfl_sync(kAll, v, (next - 1) & 31);
    if (next) v = v + t;
    rest &= __ballot_sync(kAll, !(rel & 1));
    rel >>= 1;
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adds_match_kernel(const int* __restrict__ ids, const T* __restrict__ vals,
                  long long n_in, T* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n_in;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T v = live ? vals[k * n_in + i] : T(0);
    const int p = live && v != T(0) ? ids[k * n_in + i] : -1;
    const unsigned peers = __match_any_sync(kAll, p);
    const T s = reduce_peers(peers, v);
    if (p >= 0 && lane == __ffs(peers) - 1) atomicAdd(out + p, s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adds_table_kernel(const int* __restrict__ ids, const T* __restrict__ vals,
                  long long n_in, T* __restrict__ out) {
  __shared__ HashTable<T> table[kThreads / 32];
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n_in;
  int p[4];
  T v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = live ? vals[k * n_in + i] : T(0);
    p[k] = live ? ids[k * n_in + i] : 0;
  }
  merge_rows_hash(table[threadIdx.x >> 5], p, v, out);
}

#ifdef REGRID_TABLE
// the package's merge (four rounds of __match_any_sync), fed the ring of
// each pixel's first pair
template <typename T>
__global__ void __launch_bounds__(kThreads)
adds_parity_kernel(const int* __restrict__ ids, const T* __restrict__ vals,
                   const int* __restrict__ ring1, long long n_in,
                   T* __restrict__ out) {
  __shared__ T buf[kThreads / 32][32];
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n_in;
  int p[4];
  T v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = live ? vals[k * n_in + i] : T(0);
    p[k] = live ? ids[k * n_in + i] : 0;
  }
  merge_rows(buf[threadIdx.x >> 5], live ? ring1[i] : 0, p, v, out);
}

template <typename T>
bool launch_parity(const int* id, const T* v, const void* ring1, long long n,
                   T* o, cudaStream_t s) {
  adds_parity_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
      id, v, static_cast<const int*>(ring1), n, o);
  return true;
}
#else
template <typename T>
bool launch_parity(const int*, const T*, const void*, long long, T*,
                   cudaStream_t) {
  return false;
}
#endif

template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int* __restrict__ ids, const T* __restrict__ vals,
            long long n_rows, T* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_rows) atomicAdd(out + ids[i], vals[i]);
}

}  // namespace


#define SPLIT_ENTRIES(SFX, T)                                                \
  extern "C" int regrid_compute_##SFX(int nside, long long n_in,             \
                                      const void* const* planes,             \
                                      const void* rings, void* sink,         \
                                      void* stream) {                        \
    compute_kernel<T><<<blocks_for(n_in), kThreads, 0,                       \
                        static_cast<cudaStream_t>(stream)>>>(                \
        inputs<T>(planes), static_cast<RingPtr<T>>(rings), nside, n_in,      \
        static_cast<T*>(sink));                                              \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  extern "C" int regrid_adds_##SFX(int variant, long long n,                 \
                                   const void* ids, const void* vals,        \
                                   const void* ring1, void* out,             \
                                   void* stream) {                           \
    const int* id = static_cast<const int*>(ids);                            \
    const T* v = static_cast<const T*>(vals);                                \
    T* o = static_cast<T*>(out);                                             \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                      \
    if (variant == 0)                                                        \
      adds_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(id, v, n, o);        \
    else if (variant == 1)                                                   \
      adds_match_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(id, v, n, o);  \
    else if (variant == 2)                                                   \
      adds_table_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(id, v, n, o);  \
    else if (variant == 3)                                                   \
      rows_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(id, v, n, o);        \
    else if (!launch_parity<T>(id, v, ring1, n, o, s))                       \
      return -1;                                                             \
    return static_cast<int>(cudaGetLastError());                             \
  }

SPLIT_ENTRIES(f32, float)
SPLIT_ENTRIES(f64, double)
