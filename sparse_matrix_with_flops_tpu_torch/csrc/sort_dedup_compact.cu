// K1: per-row sort, duplicate sum and left compaction of ELL-ESC tiles.
//
// Replaces the Pallas kernel sparse_matrix_with_flops_tpu/ops/pallas_sort.py
// `sort_dedup_compact` (body `_sdc_kernel`).  Per row of an [R, W] tile:
// sort the lanes by column, sum each run of equal columns, drop columns
// >= ncols and move the survivors to the left, in column order.  Padding
// is (ncols, 0.0).  Whether a lane survives depends on its column only,
// never on its value, so exact-zero sums are kept (as the reference).
//
// What bounds it on the H100: device memory is read and written once a
// lane (16 bytes), but a bitonic network makes log2(W)^2 / 2 passes over
// the row.  Done as passes through shared memory (the first design), each
// pass a barrier and a read and a write of every lane, the passes bound
// it: at W = 8192 70-91 of them, ~114 MB of shared-memory traffic each
// over a tile of 869 rows.  This design keeps the row in registers:
// 1. Packed keys.  A lane is one 64-bit word, the column (sign bit
//    flipped, so that an unsigned compare orders it as a signed int) in
//    the high half and the value's bits in the low half: a compare-
//    exchange is one 64-bit min / max, and the value rides along.  The
//    value's bits break ties, so with an unsorted input (presorted = 1)
//    the order inside a run of equal columns, and so each run's sum,
//    depends on the row's contents only.  A swap of two lanes of equal
//    column leaves the column sequence as a column-only network has it,
//    so the `presorted` hint (runs sorted by column, alternating
//    ascending / descending) stays valid whatever order equal columns
//    come in.
// 2. Register-resident stages.  Thread t of a row holds its E consecutive
//    lanes [t E, t E + E) in registers (E = 8; 16 for W >= 16384).  A
//    stage of partner distance j < E runs inside the thread, E <= j < 32 E
//    by __shfl_xor_sync between the threads of a warp, and only j >= 32 E
//    goes through shared memory: the row is stored, up to three such
//    stages at a time run on groups of 2^3 lanes that each thread loads
//    into registers (one barrier a group pass), and the row is reloaded
//    for the lower stages.  W = 8192: 12 shared-memory round trips from
//    k = 512 on, none below.  Rows of W <= 32 E lanes never touch shared
//    memory in the network: a row is sorted by W / E threads of one warp,
//    several rows to a CTA of one warp (so that a tile of a few hundred
//    short rows still spreads over the card).
// 3. Run sums by a segmented scan: each thread sums its own lanes in
//    order, then a Kogge-Stone scan of (run started, sum, kept lanes)
//    across the row's threads (shuffles, then one word a warp in shared
//    memory) gives each run's last lane the run's sum and each survivor
//    its output slot.  Every run costs O(log W) steps, the longest too
//    (the first design walked each run back lane by lane).  The sums are
//    taken in a fixed order: repeat calls are equal bit for bit.
// 4. The survivors are staged in shared memory at their slots and written
//    out with the padding by coalesced stores; the grid is sized from
//    occupancy, each CTA walking rows.
// Shared-memory words are 64-bit, loaded and stored by a thread as 16-byte
// vectors; a chunk index is XORed with bits of the thread index (phys)
// so that a quarter warp's vectors fall in distinct banks.
//
// W = 32768 does not fit one CTA (256 KB of 64-bit lanes), so that width
// runs on a cluster of two CTAs (sdc_pair_kernel), each holding one
// 16384-lane half in registers and shared memory.  Every stage but one
// has its partner lane in the same half; the one stage of distance 16384
// runs through distributed shared memory between two cluster barriers.
// The halves exchange their edge columns and, after the scan, the running
// run sum and survivor count of the first half the same way.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ u64 pack(int c, float v) {
  return (static_cast<u64>(static_cast<unsigned>(c) ^ 0x80000000u) << 32) |
         __float_as_uint(v);
}
// the column as an order key (unsigned compare = signed column order)
__device__ __forceinline__ unsigned key_col(u64 x) {
  return static_cast<unsigned>(x >> 32);
}
__device__ __forceinline__ int col_of(u64 x) {
  return static_cast<int>(key_col(x) ^ 0x80000000u);
}
__device__ __forceinline__ float val_of(u64 x) {
  return __uint_as_float(static_cast<unsigned>(x));
}
__device__ __forceinline__ void order(u64& a, u64& b, bool asc) {
  const u64 lo = a < b ? a : b;
  const u64 hi = a < b ? b : a;
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// The geometry of one kernel instance: L lanes of a row in a CTA (the
// whole row, or a half on the cluster), E a thread, TPR threads a row,
// RPC rows a CTA.
template <int W, bool PAIR>
struct Cfg {
  static constexpr int L = PAIR ? W / 2 : W;
  static constexpr int E = L <= 8 ? L : (L <= 8192 ? 8 : 16);
  static constexpr int TPR = L / E;
  static constexpr int THREADS = TPR < 32 ? 32 : TPR;
  static constexpr int RPC = THREADS / TPR;
  static constexpr int SW = TPR < 32 ? TPR : 32;  // shuffle group
  static constexpr int WARPS = THREADS / 32;
  static constexpr int LANES = RPC * L;  // 64-bit words of shared memory
  static_assert(E <= 16 && TPR <= 1024, "one thread per E lanes");
};

// Word index of lane i of the CTA's buffer: the 16-byte chunks of a
// thread's E lanes are XORed with bits of its index so that the 8 threads
// of a quarter warp reach distinct banks with their vector accesses.
template <int E>
__device__ __forceinline__ int phys(int i) {
  if constexpr (E >= 4) return i ^ (((i >> 4) & (E / 2 - 1)) << 1);
  return i;
}

template <int E>
__device__ __forceinline__ void store_lanes(u64* buf, const u64 (&x)[E],
                                            int first) {
  if constexpr (E == 1) {
    buf[first] = x[0];
  } else {
#pragma unroll
    for (int c = 0; c < E / 2; ++c)
      *reinterpret_cast<ulonglong2*>(buf + phys<E>(first + 2 * c)) =
          make_ulonglong2(x[2 * c], x[2 * c + 1]);
  }
}

template <int E>
__device__ __forceinline__ void load_lanes(const u64* buf, u64 (&x)[E],
                                           int first) {
  if constexpr (E == 1) {
    x[0] = buf[first];
  } else {
#pragma unroll
    for (int c = 0; c < E / 2; ++c) {
      const ulonglong2 q =
          *reinterpret_cast<const ulonglong2*>(buf + phys<E>(first + 2 * c));
      x[2 * c] = q.x;
      x[2 * c + 1] = q.y;
    }
  }
}

// Stages of merge k with distance j < E, inside the thread; lane0 is the
// row lane (its bit k gives the direction) of x[0].
template <int E>
__device__ __forceinline__ void reg_stages(u64 (&x)[E], int lane0, int k) {
#pragma unroll
  for (int j = E / 2; j > 0; j >>= 1) {
    if (j < k) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((e & j) == 0) order(x[e], x[e | j], ((lane0 + e) & k) == 0);
    }
  }
}

// Stages of merge k with distance E <= j < SW E: the partner lane is
// element e of the thread j / E away in the shuffle group.
template <int E, int SW>
__device__ __forceinline__ void shfl_stages(u64 (&x)[E], int rt, int lane0,
                                            int k) {
#pragma unroll
  for (int m = SW / 2; m > 0; m >>= 1) {
    if (m * E < k) {
      const bool take_min = (((lane0 & k) == 0) == ((rt & m) == 0));
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const u64 y = __shfl_xor_sync(kFull, x[e], m, SW);
        const bool lt = x[e] < y;
        x[e] = take_min == lt ? x[e] : y;
      }
    }
  }
}

// JS stages of merge k, distances j, j / 2, ..., j >> (JS - 1), on the
// CTA's buffer: each group of 2^JS lanes that those stages connect is
// loaded into one thread's registers.  g0 + (row lane) gives the
// direction (g0: the half's first lane on the cluster).
template <int JS, class C>
__device__ __forceinline__ void group_pass(u64* buf, int j, int k, int g0) {
  constexpr int G = 1 << JS;
  const int s = j >> (JS - 1);
  const int lgs = __ffs(s) - 1;
#pragma unroll 1
  for (int g = threadIdx.x; g < C::LANES / G; g += C::THREADS) {
    const int b = ((g >> lgs) << (lgs + JS)) | (g & (s - 1));
    u64 y[G];
#pragma unroll
    for (int m = 0; m < G; ++m) y[m] = buf[phys<C::E>(b + m * s)];
    const bool asc = ((g0 + (b & (C::L - 1))) & k) == 0;
#pragma unroll
    for (int q = G / 2; q > 0; q >>= 1) {
#pragma unroll
      for (int m = 0; m < G; ++m)
        if ((m & q) == 0) order(y[m], y[m | q], asc);
    }
#pragma unroll
    for (int m = 0; m < G; ++m) buf[phys<C::E>(b + m * s)] = y[m];
  }
}

// The stages of merge k with distance j >= 32 E, through shared memory.
// Returns with a CTA barrier behind the last pass.
template <class C>
__device__ __forceinline__ void smem_stages(u64* buf, int j, int k, int g0) {
  constexpr int LOW = 32 * C::E;
  while (j >= LOW) {
    const int span = 31 - __clz(j / LOW);  // stages below j down to LOW, minus one
    if (span >= 2) {
      group_pass<3, C>(buf, j, k, g0);
      j >>= 3;
    } else if (span == 1) {
      group_pass<2, C>(buf, j, k, g0);
      j >>= 2;
    } else {
      group_pass<1, C>(buf, j, k, g0);
      j >>= 1;
    }
    __syncthreads();
  }
}

// (a run starts in the span, the sum since the span's last run start,
// kept lanes)
struct Agg {
  unsigned f;
  float v;
  int k;
};

// a before b
__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  return {a.f | b.f, b.f ? b.v : a.v + b.v, a.k + b.k};
}

__device__ __forceinline__ Agg shfl_up(const Agg& a, int d, int width) {
  return {__shfl_up_sync(kFull, a.f, d, width),
          __shfl_up_sync(kFull, a.v, d, width),
          __shfl_up_sync(kFull, a.k, d, width)};
}

struct ScanSmem {
  unsigned f[32];
  float v[32];
  int k[32];
  unsigned first[32];  // each warp's first and last column keys
  unsigned last[32];
};

// The exclusive scan of ``mine`` over the threads of the row before this
// one (in thread order), and in ``total`` the row's (valid in its last
// thread).  Every thread of the CTA calls it.
template <class C>
__device__ __forceinline__ Agg row_scan(const Agg& mine, ScanSmem& sm,
                                        Agg& total) {
  Agg inc = mine;
  Agg ex{0u, 0.0f, 0};
  if constexpr (C::SW > 1) {
    const int gl = threadIdx.x & (C::SW - 1);
#pragma unroll
    for (int d = 1; d < C::SW; d <<= 1) {
      const Agg p = shfl_up(inc, d, C::SW);
      if (gl >= d) inc = combine(p, inc);
    }
    const Agg p = shfl_up(inc, 1, C::SW);
    if (gl >= 1) ex = p;
  }
  if constexpr (C::TPR > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 31) {
      sm.f[warp] = inc.f;
      sm.v[warp] = inc.v;
      sm.k[warp] = inc.k;
    }
    __syncthreads();
    Agg wc{0u, 0.0f, 0};
    for (int w = warp & ~(C::TPR / 32 - 1); w < warp; ++w)
      wc = combine(wc, Agg{sm.f[w], sm.v[w], sm.k[w]});
    ex = combine(wc, ex);
  }
  total = combine(ex, mine);
  return ex;
}

// After the network: the per-lane run flags, the thread's own segmented
// sums, the row scan.  Lane e of the thread is a survivor when its bit
// of ``keep`` is set; after finish(), its slot (counted from the CTA's
// first survivor of the row) is slot(e) and its run's sum s[e].
template <class C>
struct Runs {
  unsigned start;  // a run begins at the lane
  unsigned keep;
  float s[C::E];
  Agg ex;     // what the row's earlier threads in this CTA hold
  Agg total;  // the CTA part of the row (valid in its last thread)

  // has_prev / prev_key: the column key of the lane before the thread's
  // first (none at the row's start); has_next / next_key: after its last.
  __device__ __forceinline__ void scan(const u64 (&x)[C::E], bool has_prev,
                                       unsigned prev_key, bool has_next,
                                       unsigned next_key, int ncols,
                                       ScanSmem& sm) {
    constexpr int E = C::E;
    start = 0u;
    keep = 0u;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned kc = key_col(x[e]);
      const bool st = e == 0 ? (!has_prev || prev_key != kc)
                             : key_col(x[e > 0 ? e - 1 : 0]) != kc;
      const bool lst = e == E - 1 ? (!has_next || next_key != kc)
                                  : key_col(x[e < E - 1 ? e + 1 : e]) != kc;
      start |= static_cast<unsigned>(st) << e;
      keep |= static_cast<unsigned>(lst && col_of(x[e]) < ncols) << e;
      const float v = val_of(x[e]);
      s[e] = (e == 0 || st) ? v : s[e > 0 ? e - 1 : 0] + v;
    }
    ex = row_scan<C>(Agg{start != 0u ? 1u : 0u, s[E - 1], __popc(keep)}, sm,
                     total);
  }

  // Add the open run of the earlier lanes to the lanes before the
  // thread's first run start.
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int e = 0; e < C::E; ++e)
      if ((start & ((2u << e) - 1u)) == 0u) s[e] = ex.v + s[e];
  }
  // The same when ``carry`` (the first half of the row, on the cluster)
  // precedes the CTA's part; slots stay counted from the CTA's part.
  __device__ __forceinline__ void finish(const Agg& carry) {
    ex = combine(Agg{carry.f, carry.v, 0}, ex);
    finish();
  }

  __device__ __forceinline__ int slot(int e) const {
    return ex.k + __popc(keep & ((1u << e) - 1u));
  }
};

// The neighbouring column keys across the thread's edges inside the
// CTA's part of the row: shuffles in the group, the warp edge words
// across warps.  ``row_first`` / ``row_last``: this thread holds the
// CTA part's first / last lanes.
template <class C>
__device__ __forceinline__ void edges(const u64 (&x)[C::E], ScanSmem& sm,
                                      int rt, unsigned& prev_key,
                                      unsigned& next_key) {
  const unsigned first = key_col(x[0]);
  const unsigned last = key_col(x[C::E - 1]);
  prev_key = 0u;
  next_key = 0u;
  if constexpr (C::SW > 1) {
    prev_key = __shfl_up_sync(kFull, last, 1, C::SW);
    next_key = __shfl_down_sync(kFull, first, 1, C::SW);
  }
  if constexpr (C::TPR > 32) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) sm.first[warp] = first;
    if (lane == 31) sm.last[warp] = last;
    __syncthreads();
    if (lane == 0 && rt > 0) prev_key = sm.last[warp - 1];
    if (lane == 31 && rt < C::TPR - 1) next_key = sm.first[warp + 1];
  }
}

// The bitonic network over the CTA's rows, from merge kstart; x holds the
// thread's lanes on entry and exit.  On the cluster (PAIR) the stage of
// distance L crosses to the peer half.
template <class C, bool PAIR>
__device__ __forceinline__ void network(u64 (&x)[C::E], u64* buf, int kstart,
                                        int rt, int g0) {
  constexpr int E = C::E;
  const int lane0 = g0 + rt * E;
  for (int k = kstart; k <= (PAIR ? 2 * C::L : C::L); k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * E) {  // only rows of more than 32 threads get here
      store_lanes<E>(buf, x, threadIdx.x * E);
      if constexpr (PAIR) {
        if (j == C::L) {
          // k = W: every pair (l, L + l) ascends; the low lane lies in
          // CTA 0.  Each CTA takes half of the L pairs.
          cg::cluster_group cluster = cg::this_cluster();
          const int rank = static_cast<int>(cluster.block_rank());
          cluster.sync();
          u64* lo = rank == 0 ? buf : cluster.map_shared_rank(buf, 0);
          u64* hi = rank == 0 ? cluster.map_shared_rank(buf, 1) : buf;
          for (int l = rank * (C::L / 2) + threadIdx.x;
               l < (rank + 1) * (C::L / 2); l += C::THREADS) {
            const int p = phys<E>(l);
            u64 a = lo[p];
            u64 b = hi[p];
            order(a, b, true);
            lo[p] = a;
            hi[p] = b;
          }
          cluster.sync();
          j >>= 1;
        } else {
          __syncthreads();
        }
      } else {
        __syncthreads();
      }
      smem_stages<C>(buf, j, k, g0);
      load_lanes<E>(buf, x, threadIdx.x * E);
    }
    shfl_stages<E, C::SW>(x, rt, lane0, k);
    reg_stages<E>(x, lane0, k);
  }
}

template <int W>
__global__ void __launch_bounds__(Cfg<W, false>::THREADS)
    sdc_kernel(const int* __restrict__ tc, const float* __restrict__ tv,
               int* __restrict__ kout, float* __restrict__ vout, int R,
               int ncols, int kstart) {
  using C = Cfg<W, false>;
  constexpr int E = C::E;
  extern __shared__ __align__(16) u64 buf[];
  __shared__ ScanSmem sm;
  __shared__ int kept[C::RPC];
  const int rt = threadIdx.x & (C::TPR - 1);
  const int rl = threadIdx.x / C::TPR;
  const int groups = (R + C::RPC - 1) / C::RPC;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long row0 = static_cast<long long>(grp) * C::RPC;
    const long long base = row0 * W;
    const int valid =
        static_cast<int>(min(static_cast<long long>(C::RPC), R - row0)) * W;
    for (int i = threadIdx.x; i < C::LANES; i += C::THREADS)
      buf[phys<E>(i)] = i < valid ? pack(tc[base + i], tv[base + i])
                                  : pack(ncols, 0.0f);
    __syncthreads();
    u64 x[E];
    load_lanes<E>(buf, x, threadIdx.x * E);
    network<C, false>(x, buf, kstart, rt, 0);

    unsigned prev_key, next_key;
    edges<C>(x, sm, rt, prev_key, next_key);
    Runs<C> runs;
    runs.scan(x, rt > 0, prev_key, rt < C::TPR - 1, next_key, ncols, sm);
    runs.finish();
    if (rt == C::TPR - 1) kept[rl] = runs.total.k;
    __syncthreads();  // every thread is done reading buf
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((runs.keep >> e) & 1u)
        buf[rl * W + runs.slot(e)] = pack(col_of(x[e]), runs.s[e]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < valid; i += C::THREADS) {
      const int l = i & (W - 1);
      int c = ncols;
      float v = 0.0f;
      if (l < kept[i / W]) {
        const u64 y = buf[i];
        c = col_of(y);
        v = val_of(y);
      }
      kout[base + i] = c;
      vout[base + i] = v;
    }
    __syncthreads();  // before the next rows overwrite buf and kept
  }
}

// One row of W lanes over a cluster of two CTAs; CTA r holds row lanes
// [r L, r L + L) and writes the output slots of the same range.
__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(Cfg<32768, true>::THREADS)
        sdc_pair_kernel(const int* __restrict__ tc,
                        const float* __restrict__ tv, int* __restrict__ kout,
                        float* __restrict__ vout, int ncols, int kstart) {
  using C = Cfg<32768, true>;
  constexpr int E = C::E;
  constexpr int W = 2 * C::L;
  extern __shared__ __align__(16) u64 buf[];
  __shared__ ScanSmem sm;
  __shared__ unsigned edge_key[2];  // this half's first and last column keys
  __shared__ Agg half_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rt = threadIdx.x;
  const int g0 = rank * C::L;
  const long long base = static_cast<long long>(blockIdx.x >> 1) * W;
  for (int i = threadIdx.x; i < C::L; i += C::THREADS)
    buf[phys<E>(i)] = pack(tc[base + g0 + i], tv[base + g0 + i]);
  __syncthreads();
  u64 x[E];
  load_lanes<E>(buf, x, threadIdx.x * E);
  network<C, true>(x, buf, kstart, rt, g0);

  unsigned prev_key, next_key;
  edges<C>(x, sm, rt, prev_key, next_key);
  if (rt == 0) edge_key[0] = key_col(x[0]);
  if (rt == C::TPR - 1) edge_key[1] = key_col(x[E - 1]);
  cluster.sync();
  const unsigned* peer_edge = cluster.map_shared_rank(edge_key, rank ^ 1);
  if (rt == 0 && rank == 1) prev_key = peer_edge[1];
  if (rt == C::TPR - 1 && rank == 0) next_key = peer_edge[0];
  Runs<C> runs;
  runs.scan(x, rt > 0 || rank == 1, prev_key, rt < C::TPR - 1 || rank == 0,
            next_key, ncols, sm);
  if (rt == C::TPR - 1) half_total = runs.total;
  cluster.sync();  // both halves' totals visible; every buf read is done
  const Agg peer = *cluster.map_shared_rank(&half_total, rank ^ 1);
  const int mine = half_total.k;
  if (rank == 1) {
    runs.finish(peer);  // runs open at the end of the first half go on here
  } else {
    runs.finish();
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if ((runs.keep >> e) & 1u)
      buf[runs.slot(e)] = pack(col_of(x[e]), runs.s[e]);
  }
  __syncthreads();
  const int first_slot = rank == 0 ? 0 : peer.k;
  for (int i = threadIdx.x; i < mine; i += C::THREADS) {
    const u64 y = buf[i];
    kout[base + first_slot + i] = col_of(y);
    vout[base + first_slot + i] = val_of(y);
  }
  for (int g = max(mine + peer.k, g0) + threadIdx.x; g < g0 + C::L;
       g += C::THREADS) {
    kout[base + g] = ncols;
    vout[base + g] = 0.0f;
  }
  cluster.sync();  // keep this CTA's shared memory alive for the peer
}

// The grid of sdc_kernel<W> on the current device: as many CTAs as are
// resident at once, at most one a row group.  The shared-memory
// attribute and the occupancy are set up once a device.
template <int W>
int launch_rows(const int* tc, const float* tv, int* kout, float* vout, int R,
                int ncols, int kstart, cudaStream_t stream) {
  using C = Cfg<W, false>;
  static int resident[kMaxDevices];
  const size_t smem = static_cast<size_t>(C::LANES) * sizeof(u64);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(sdc_kernel<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sdc_kernel<W>,
                                                        C::THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  const int groups = (R + C::RPC - 1) / C::RPC;
  const int grid = groups < resident[dev] ? groups : resident[dev];
  sdc_kernel<W><<<grid, C::THREADS, smem, stream>>>(tc, tv, kout, vout, R,
                                                    ncols, kstart);
  return static_cast<int>(cudaGetLastError());
}

int launch_pair(const int* tc, const float* tv, int* kout, float* vout, int R,
                int ncols, int kstart, cudaStream_t stream) {
  using C = Cfg<32768, true>;
  const size_t smem = static_cast<size_t>(C::LANES) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      sdc_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sdc_pair_kernel<<<2 * R, C::THREADS, smem, stream>>>(tc, tv, kout, vout,
                                                       ncols, kstart);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// W: a power of two up to 32768 (the Python wrapper checks).  Rows up to
// 16384 lanes run sdc_kernel<W>; 32768-lane rows a 2-CTA cluster each.
// Returns the cudaError_t of the launch.
extern "C" int smf_sort_dedup_compact(const int* tc, const float* tv,
                                      int* kout, float* vout, int R, int W,
                                      int ncols, int presorted,
                                      cudaStream_t stream) {
  const int kstart = presorted > 1 ? 2 * presorted : 2;
  switch (W) {
#define SMF_SDC_CASE(w) \
  case w:               \
    return launch_rows<w>(tc, tv, kout, vout, R, ncols, kstart, stream);
    SMF_SDC_CASE(1)
    SMF_SDC_CASE(2)
    SMF_SDC_CASE(4)
    SMF_SDC_CASE(8)
    SMF_SDC_CASE(16)
    SMF_SDC_CASE(32)
    SMF_SDC_CASE(64)
    SMF_SDC_CASE(128)
    SMF_SDC_CASE(256)
    SMF_SDC_CASE(512)
    SMF_SDC_CASE(1024)
    SMF_SDC_CASE(2048)
    SMF_SDC_CASE(4096)
    SMF_SDC_CASE(8192)
    SMF_SDC_CASE(16384)
#undef SMF_SDC_CASE
    case 32768:
      return launch_pair(tc, tv, kout, vout, R, ncols, kstart, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
