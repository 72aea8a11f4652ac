// K6-K8: the ring exchanges of the sharded R-MCL loop, in two launch
// modes: every rank of the ring stacked on one card in one launch, or one
// rank a launch, for ranks in separate processes (one a card, or sharing
// one).
//
// Replace the Pallas kernels of sparse_matrix_with_flops_tpu/parallel/
// pallas_ring.py:
//   K6 smf_ring_all_gather   <- `ring_all_gather`   (:64, body
//                               `_ring_ag_kernel`)
//   K7 smf_ring_matmul       <- `ring_matmul`       (:136, body
//                               `_ring_mm_kernel`)
//   K8 smf_ring_matmul_tiled <- `ring_matmul_tiled` (:254, body
//                               `_ring_mm_tiled_kernel`)
//
// There each chip ran one program and forwarded blocks to its neighbour
// with remote DMAs, one semaphore pair per region.  Here the protocol is
// the reference's write-once, one-writer-per-region ring: a rank reads
// only its own buffers; its upstream neighbour writes into them and then
// one thread fences and raises the flag of the region.  Every rank's
// buffers are reached only through its own base pointer, so one kernel
// serves both modes:
// * stacked (smf_ring_all_gather, smf_ring_matmul, smf_ring_matmul_tiled):
//   one cooperative launch runs all D ranks, blockIdx.y is the rank,
//   gridDim.x CTAs work on one rank's region, and the pointers are the
//   ranks' blocks of the stacked tensors, in the launch's parameters;
// * one rank a launch (smf_ring_all_gather_rank, smf_ring_matmul_rank):
//   the grid is (gridDim.x, 1), the rank comes from the parameters, and
//   the neighbour's buffers and flags are peer pointers (CUDA IPC
//   mappings of the other processes' allocations, parallel/peer.py).
// Fences and atomics are system-scope and blocks written by another rank
// are read through L2 (__ldcg, cp.async.cg), never the incoherent L1, so
// the code is the same whether the neighbour is a CTA row of this launch,
// another process on this card or another card.  Ranks spin on each
// other's flags, so every CTA of a launch must be resident at once: the
// launch is cooperative and sized from occupancy (stacked: the card's
// resident CTAs over D; one rank a launch: over the ranks that share the
// card), and a grid larger than what fits is refused by
// cudaLaunchCooperativeKernel (the wrapper raises) instead of
// deadlocking.  Every wait on a flag is bounded: after kWaitNs of
// %globaltimer the thread traps, so a rank that never arrives fails the
// launch (an error at the next synchronize) and never hangs the card.
//
// Flags carry the epoch of the launch that raised them and are never
// cleared.  Stacked, K6's flags are kept per (device, stream) and its
// epoch advances with the stream's launches (`_build.stream_scratch`; a
// launch captured into a CUDA graph gets flags of its own that the graph
// zeroes); K7 / K8's caller zeroes their flags before every launch and
// passes epoch 1.  One rank a launch, each rank's flags live beside its
// landing buffers in its peer allocation, zeroed once, and the epoch comes
// from the card: a launch is given a pointer to an int32 counter of its
// set (the last launch's epoch, 0 at first), every CTA reads it at entry
// and takes epoch = counter % kEpochs + 1, and the entry point enqueues,
// right after the launch, a one-thread kernel that stores that epoch into
// the counter (a launch never writes its own counter: its CTAs may still
// be reading it).  So a CUDA graph that captured the launch and its
// advance gives every replay a new epoch, and eager launches and replays
// can interleave on one counter.  Every rank of a set runs the same
// sequence of launches on it (each launch is collective), so the ranks'
// counters move in step.  (Zeroing the flags in a graph node instead, as
// stacked launches do, would race across processes: a rank could zero a
// flag that its neighbour has already raised for this replay.)  Two more
// waits make launches of separate processes safe, since a rank's stream
// no longer orders its neighbours' launches: (1) at entry, CTA 0 of every
// rank raises its `ready` flag, and no CTA writes into its downstream
// neighbour's buffers before that neighbour's ready flag carries this
// epoch (the neighbour's stream is then done with the buffers' previous
// contents); (2) K6 waits for its last block to land before the launch
// ends (the stacked launch's end covers it).  K7 / K8 read their last
// block inside the launch, so they need no such wait.  K6 one rank a
// launch takes a number of hops: d - 1 is the all-gather, 1 is
// ppermute(i -> i + 1) (the rank's own block 0 and the upstream rank's
// block 1 land), the same copies and flag walk cut short.
//
// K6 moves d blocks a rank (at D = 4 on R-MAT s14, [4096, 128] 4-byte
// blocks of cols and vals: 16.8 MB in, 67 MB out), so it is bound by
// device-memory bandwidth once the hops overlap; its design:
// 1. One launch for every operand (cols and vals together), the ranks'
//    pointers in a __grid_constant__ parameter struct: no pointer array
//    and no flag memset before the launch.
// 2. Per-slice flags: CTA i of every rank owns the same slice of every
//    block, and waits only for CTA i of the upstream rank, so the d - 1
//    hops pipeline slice by slice instead of in whole-grid steps.
// 3. Hop 0 reads the input once and writes both the rank's own block 0
//    and the neighbour's block 1; later hops read the block that the
//    upstream CTA has just written, from L2.  Copies are 16-byte with
//    scalar heads and tails, the CTA's warps split over the operands.
// What bounds it (variants timed on the card, `ring_probe.py variants`;
// PERF.md): the traffic.  Besides the inputs and outputs, each rank reads
// back the d - 2 blocks it forwards, since only its upstream neighbour
// writes them; the flag waits cost next to nothing.
//
// K7 / K8: C[me] = A_rot[me] . concat(B), block k of B contracted at hop
// k.  K7's blocks flow right (block k is owner (me - k) mod d), K8's left
// (owner (me + k) mod d), so K8's sums follow the unfused ring chain's
// owner order; K8 runs over N tiles of nt columns.  Block 0 is read from
// the rank's own B in place, so a rank never writes its own buffer.
//
// Their bound on the H100.  At D = 4 on R-MAT s14 a rank contracts
// [297, 4 x 4096] . [4 x 4096, 16384]: 637.8 GFLOP over the four ranks,
// most of it the planner's zero padding, against 1.23 GB of operands and
// result (0.37 ms at 3.35 TB/s): operation-bound.  Done f32-accurately as
// three TF32 tensor-core passes it takes 3 x 637.8 / 495 = 3.87 ms at the
// card's peak (9.52 ms on f32 FFMA); D = 2 (401.6 GFLOP) 2.43 ms.  The
// design, item by item:
// 1. Tensor cores on 3xTF32 splits.  x = hi + lo, hi = cvt.rna.tf32(x),
//    lo = cvt.rna.tf32(x - hi); wgmma m64n64k8 adds lo.hi, hi.lo and
//    hi.hi (the dropped lo.lo term is ~2^-22 relative).  A comes from
//    registers: each thread loads its fragment of the loaded A tile and
//    splits it there (raw_k orders a stage's depth so that a fragment is
//    one float4 a row).  tf32 wgmma reads B K-major only and B arrives
//    N-major, so each consumer warpgroup splits the stage's B tile into
//    its own K-major core matrices in shared memory.  The tensor cores
//    add into their accumulator by truncation, so a sum over all of K
//    drifts low (on the s14 hub operands by up to 2e-5 of |A||B|, enough
//    to move R-MCL iterates by 1e-4): each stage's 16-deep sum goes to a
//    fresh accumulator that is then added into f32 registers with
//    round-to-nearest.  The two register sets cap a CTA at 64 columns
//    and, with the producer, at 3 warpgroups of two m64 tiles (M up to
//    384; tiles wholly past M are skipped) or 4 of one.
// 2. The hop overlaps the contraction.  A CTA owns every row of a strip
//    of kBN = 64 columns, so each strip of a B block is read by exactly
//    one CTA.  A producer warpgroup keeps up to 8 stages in flight (A's
//    tile by TMA from a map of the rank's A_rot, built once a launch, B's
//    by cp.async) and, a few stages behind, copies each landed B tile from
//    shared memory into the neighbour's buffer; the consumer warpgroups
//    run their products meanwhile, each at its own pace (mbarriers, no
//    block-wide barrier in the loop).  Rows of M past one chunk loop over
//    further chunks, which re-read the blocks (already resident, nothing
//    forwarded).  At D = 4, nt = 2048: 32 strips a tile, 256 a rank, on 33
//    resident CTAs a rank.
// 3. Point-to-point sync.  One flag per (rank, strip, hop), raised by the
//    producer of the one upstream CTA that forwarded that strip, so a CTA
//    waits only for its own strip's upstream.  The sums of all d hops stay
//    in registers (block 0, 1, ..., d - 1 in order, k ascending within a
//    block) and C is written once.  K8's buffer holds `slots` N tiles in
//    turn (two, from the wrapper): a CTA about to overwrite the
//    neighbour's slot for strip s first waits for the neighbour's flag
//    that it has read the strip that used it last, in place of a
//    whole-rank entry barrier per tile.  Every CTA walks its strips in
//    increasing order on every rank, each wait is for an earlier strip or
//    an earlier hop of the same strip, and a producer publishes every
//    stage it holds before it waits for a flag, so no cycle of waits can
//    form among resident CTAs.
// 4. Co-residency.  A CTA takes up to 227 KB of dynamic shared memory:
//    the attribute is set and the occupancy query is given that size
//    before the grid is sized (once a device and kernel instance).
// 5. Nothing is copied to the card before a launch.  Every rank's base
//    pointers and A's TMA maps (encoded on the host at each launch) are
//    members of the kernel's __grid_constant__ parameter struct, as K6's
//    pointers are, and the caller's flags are zeroed by a memset: a CUDA
//    graph can capture the launch, and a replay reruns the memset.  The
//    struct holds kMaxRanks ranks, as many as 32,764 bytes of parameters
//    hold; the wrapper refuses more.
// 6. Memory order.  The system-scope release/acquire of the flags stays.
//    A forwarded tile is written by ordinary stores and read downstream
//    by cp.async.cg, both generic-proxy operations, so no proxy fence is
//    needed there; A, read by TMA, is never written in the launch.  The
//    split B parts are written by the generic proxy and read by wgmma
//    through the async proxy: fence.proxy.async precedes the barrier of
//    the warpgroup that publishes them.
// What bounds it (variants timed against it on the card; PERF.md): the
// consumers' own loop.  With no loads and no B split, each warpgroup's
// chains of small dependent wgmmas and its f32 promotions still leave
// the tensor cores idle about half the time; the loads, the forwards and
// the split add about a third on top.
#include <cuda.h>
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using smf::cp_async16;
using smf::cp_async_commit;
using smf::cp_async_wait;
using smf::mbar_arrive;
using smf::mbar_expect;
using smf::mbar_init;
using smf::mbar_wait;
using smf::smem_u32;
using smf::split_tf32;
using smf::tma_load;

using Flag = cuda::atomic_ref<int, cuda::thread_scope_system>;

// How long a thread waits for another rank's flag before it traps.
constexpr unsigned long long kWaitNs = 30ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until ``flag`` holds ``epoch`` (acquire), sleeping kSleep ns a
// turn; trap after kWaitNs.
template <unsigned kSleep>
__device__ __forceinline__ void wait_epoch(int* flag, int epoch) {
  Flag f(*flag);
  if (f.load(cuda::std::memory_order_acquire) == epoch) return;
  const unsigned long long t0 = global_ns();
  while (f.load(cuda::std::memory_order_acquire) != epoch) {
    __nanosleep(kSleep);
    if (global_ns() - t0 > kWaitNs) __trap();
  }
}

// Epochs run 1 .. kEpochs, then start again at 1 (_build.EPOCHS).
constexpr int kEpochs = (1 << 30) - 1;

// The epoch of a launch: the caller's, or (one rank a launch) the one
// after the last epoch stored in ``counter``.  The counter was written by
// an earlier kernel on the stream: read it from L2.
__device__ __forceinline__ int launch_epoch(const int* counter, int epoch) {
  return counter ? __ldcg(counter) % kEpochs + 1 : epoch;
}

// Stores the epoch of the launch before it on the stream into ``counter``.
__global__ void advance_epoch(int* counter) { *counter = *counter % kEpochs + 1; }

// ---- K6 ---------------------------------------------------------------
constexpr int kGatherThreads = 256;
// rank pointers an operand list of the launch's parameters holds (ops * d):
// the usual call takes the small instance, whose ~300 bytes of parameters
// launch ~8 us sooner than the large one's ~32.7 KB (device time the same;
// `ring_probe.py variants`, PERF.md)
constexpr int kPtrsSmall = 16;
constexpr int kPtrsLarge = 2040;  // CUDA >= 12.1 allows 32,764 bytes of parameters
#if CUDART_VERSION < 12010
#error "K6 needs CUDA 12.1 or newer: its launch parameters hold 2040 rank pointers"
#endif

// The launch's parameters, a __grid_constant__: no pointer array to copy
// to the device before the launch.
template <int P>
struct Gather {
  const unsigned* in[P];  // [op * d + r]: rank r's block of operand op
  unsigned* out[P];       // [op * d + r]: rank r's d blocks of operand op
  int* flags;             // [d, d - 1, gridDim.x] arrivals, then [d] ready;
                          // see the kernel (one rank a launch: this rank's)
  int* flags_dst;         // the downstream rank's flags (stacked: flags)
  long long words;        // 4-byte words of a block
  long long slice;        // words of each block a CTA owns, a multiple of 4
  const int* counter;     // one rank a launch: the set's epoch counter; stacked: null
  int d, ops, epoch;      // epoch: stacked only (one rank a launch: from counter)
  int rank;               // one rank a launch: the rank; stacked: -1
  int hops;               // blocks that land past block 0 (stacked: d - 1)
};

// Threads t < T of a group copy ``len`` words from ``src`` to ``dst`` (and
// to ``dst2`` when it is not null): 16-byte where the addresses agree
// modulo 16 bytes, after a scalar head that brings them to the 16-byte
// grid, with a scalar tail.  Each thread has up to four 16-byte loads in
// flight before it stores.  ``fresh``: the source was written in this
// launch, read it from L2 (__ldcg), never the incoherent L1.
__device__ void copy_slice(const unsigned* src, unsigned* dst, unsigned* dst2,
                           long long len, bool fresh, int t, int T) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t c = dst2 ? reinterpret_cast<uintptr_t>(dst2) : b;
  long long head = len, nvec = 0;
  if ((((a ^ b) | (a ^ c)) & 15) == 0) {
    head = static_cast<long long>((16 - (a & 15)) & 15) / 4;
    if (head > len) head = len;
    nvec = (len - head) / 4;
  }
  for (long long i = t; i < head; i += T) {
    const unsigned w = fresh ? __ldcg(src + i) : __ldg(src + i);
    dst[i] = w;
    if (dst2) dst2[i] = w;
  }
  const uint4* vs = reinterpret_cast<const uint4*>(src + head);
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  uint4* vd2 = dst2 ? reinterpret_cast<uint4*>(dst2 + head) : nullptr;
  for (long long i = t; i < nvec; i += 4 * T) {
    uint4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j * T < nvec) w[j] = fresh ? __ldcg(vs + i + j * T) : __ldg(vs + i + j * T);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j * T < nvec) {
        vd[i + j * T] = w[j];
        if (vd2) vd2[i + j * T] = w[j];
      }
    }
  }
  for (long long e = head + nvec * 4 + t; e < len; e += T) {
    const unsigned w = fresh ? __ldcg(src + e) : __ldg(src + e);
    dst[e] = w;
    if (dst2) dst2[e] = w;
  }
}

// CTA i of rank me owns words [i * slice, (i + 1) * slice) of every block
// of every operand, at every hop.  Hop 0 copies the slice of its input
// into its own block 0 and the downstream rank's block 1 in one read.  At
// hop k >= 1 it raises the downstream rank's flag (dst, k, i) for what it
// stored at hop k - 1, waits for CTA i of the upstream rank to have
// raised its own flag (me, k, i), and forwards the slice of its block k
// into the downstream rank's block k + 1.  Stacked, the last block, d - 1,
// is read by no hop, so no flag announces it; one rank a launch, a last
// round raises and waits for it, so that the launch ends only once the
// rank's blocks have all landed: blocks 1 .. hops, hops = d - 1 for the
// all-gather, 1 for a ppermute.  One rank a launch, the CTA first waits
// for the downstream rank's ready flag (raised by its CTA 0 at entry).  A
// flag holds the epoch of the launch that last raised it, so flags are
// never cleared.
template <int P>
__global__ void __launch_bounds__(kGatherThreads)
    ring_all_gather_kernel(const __grid_constant__ Gather<P> p) {
  const int me = p.rank < 0 ? static_cast<int>(blockIdx.y) : p.rank, d = p.d;
  const int dst = me + 1 == d ? 0 : me + 1;
  const int epoch = launch_epoch(p.counter, p.epoch);
  const long long lo = blockIdx.x * p.slice;
  const long long len = lo < p.words ? min(p.slice, p.words - lo) : 0;
  // flag (rank, k) of CTA i: flags[(rank * (d - 1) + k - 1) * gridDim.x + i]
  const long long stride = gridDim.x;
  int* const mine = p.flags + (me * (d - 1LL) - 1) * stride + blockIdx.x;
  int* const theirs = p.flags_dst + (dst * (d - 1LL) - 1) * stride + blockIdx.x;
  if (p.rank >= 0 && d > 1) {
    if (threadIdx.x == 0) {
      const long long ready = d * (d - 1LL) * stride;  // [d] after the arrivals
      if (blockIdx.x == 0)
        Flag(p.flags[ready + me]).store(epoch, cuda::std::memory_order_release);
      wait_epoch<32>(p.flags_dst + ready + dst, epoch);
    }
    __syncthreads();
  }
  // the CTA's warps split evenly over the operands, so that each thread
  // copies one operand's units with all its loads in flight at once
  const int groups = min(p.ops, kGatherThreads / 32);
  const int gsize = kGatherThreads / 32 / groups * 32;
  const int g = threadIdx.x / gsize, t = threadIdx.x % gsize;
  for (int op = g; op < p.ops && g < groups; op += groups) {
    const int r = op * d;
    copy_slice(p.in[r + me] + lo, p.out[r + me] + lo,
               d > 1 ? p.out[r + dst] + p.words + lo : nullptr, len, false, t, gsize);
  }
  // one rank a launch: a last round for block hops
  const int rounds = p.rank < 0 ? p.hops : p.hops + 1;
  for (int k = 1; k < rounds; ++k) {
    __syncthreads();  // the slice of hop k - 1 is stored
    // the barrier orders the CTA's stores before thread 0's system-scope
    // release, and its acquire before the CTA's loads of the next hop
    if (threadIdx.x == 0) {
      Flag(theirs[k * stride]).store(epoch, cuda::std::memory_order_release);
      wait_epoch<32>(&mine[k * stride], epoch);
    }
    __syncthreads();
    if (k == p.hops) break;  // the last block is forwarded by no hop
    for (int op = g; op < p.ops && g < groups; op += groups) {
      const int r = op * d;
      copy_slice(p.out[r + me] + k * p.words + lo,
                 p.out[r + dst] + (k + 1) * p.words + lo, nullptr, len, true, t, gsize);
    }
  }
}

// ---- K7 / K8 ----------------------------------------------------------
// Ranks the launch's parameters hold: a rank takes a TMA map and four
// pointers (160 bytes), and the struct may take 32,764 bytes (CUDA >= 12.1).
constexpr int kMaxRanks = 204;
constexpr int kMaxParamBytes = 32764;

// The launch's parameters, a __grid_constant__ (TMA reads A's maps in
// place): no pointer array or map is copied to the card before a launch.
struct RingMatmul {
  CUtensorMap amaps[kMaxRanks];  // [d] TMA maps of the ranks' A_rot (if tma)
  const float* a[kMaxRanks];     // [d] A_rot [M, d * lr], block k at cols k*lr
  const float* b[kMaxRanks];     // [d] B [lr, N]
  float* buf[kMaxRanks];         // [d] rotating buffer [slots, d - 1, lr, nt]
  float* c[kMaxRanks];           // [d] C [M, N]
  // [d, strips, d] arrivals, [d, strips] done, then [d] ready (one rank a
  // launch: this rank's flags; stacked: every rank's)
  int* flags;
  int* flags_dst;         // the downstream rank's flags (stacked: flags)
  const int* counter;     // one rank a launch: the set's epoch counter; stacked: null
  int d, m, lr, n, nt;
  int slots;  // N tiles the buffer holds; tile t uses slot t % slots
  int dir;  // +1: blocks flow to rank me + 1 (K7); -1: to me - 1 (K8)
  int rank;   // one rank a launch: the rank; stacked: -1 (blockIdx.y)
  int epoch;  // the tag the launch's flags carry (stacked; else from counter)
  int tma;    // amaps hold the maps (else the producer loads A itself)
};
static_assert(sizeof(RingMatmul) <= kMaxParamBytes, "K7 / K8's parameters overflow");
static_assert(sizeof(RingMatmul) + sizeof(CUtensorMap) + 4 * sizeof(void*) > kMaxParamBytes,
              "kMaxRanks is not the most ranks the parameters hold");

__device__ __forceinline__ int rank_of(const RingMatmul& p) {
  return p.rank < 0 ? static_cast<int>(blockIdx.y) : p.rank;
}

constexpr int kBN = 64;   // columns of a strip: the wgmma N
constexpr int kBK = 16;   // contraction depth of a stage: two k8 steps
constexpr int kCore = 32;      // floats of an 8 x 4 core matrix (128 bytes)
constexpr int kAcc = kBN / 2;  // accumulators a thread holds for an m64 tile
constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may take

// A CTA of W consumer warpgroups, each owning TP m64 tiles of a chunk of
// 64 W TP rows, and one producer warpgroup.  Shared memory: a ring of
// kStages stages, each A's [BM, kBK] tile and B's [kBK, kBN] tile as
// loaded (row-major); each consumer warpgroup's two buffers of B's TF32
// hi and lo parts (K-major core matrices); a full and an empty mbarrier
// a stage.
template <int W, int TP>
struct Tiling {
  static constexpr int kConsumers = 128 * W;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kBM = 64 * W * TP;
  static constexpr int kTileA = kBM * kBK;
  static constexpr int kTileB = kBN * kBK;
  static constexpr int kStage = kTileA + kTileB;  // floats
  static constexpr int kSplit = W * 2 * 2 * kTileB;
  static constexpr int kFit = (kSmemMax - 1024 - kSplit * 4) / (kStage * 4);
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  // stages the producer has in flight behind the one it publishes
  static constexpr int kLag = kStages - 2 < 3 ? kStages - 2 : 3;
  static constexpr int kSmem = (kStages * kStage + kSplit) * 4 + kStages * 16;
};

// Offset (floats) of element (row, k) of a [rows, kBK] K-major operand
// tile in 8 x 4 core matrices, no swizzle: the next 4 k at +128 bytes
// (the descriptor's LBO), the next 8 rows at +kBK / 4 x 128 bytes (SBO).
__device__ __forceinline__ int core_off(int row, int k) {
  return ((row / 8) * (kBK / 4) + k / 4) * kCore + (row % 8) * 4 + k % 4;
}

// The depth order of a stage as the tensor cores see it.  A thread's A
// fragment of k8 step ks holds fragment columns q and q + 4; taking them
// as the stage's columns 4q + 2ks and 4q + 2ks + 1 gives each thread one
// float4 of each of its rows for both steps.  B is split into the same
// order: row kap = 8 ks + j of the split stage is loaded row 4 (j % 4) +
// 2 ks + j / 4.
__device__ __forceinline__ int raw_k(int kap) {
  const int ks = kap / 8, j = kap % 8;
  return 4 * (j % 4) + 2 * ks + j / 4;
}

__device__ __forceinline__ unsigned long long desc(const void* tile) {
  return static_cast<unsigned long long>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>(128 >> 4) << 16) |
         (static_cast<unsigned long long>((kBK / 4) * 128 >> 4) << 32);
}

// d[64 x kBN] = a[64 x 8] . b[8 x kBN] (+ d if ``add``) for the
// warpgroup, TF32 products: a from registers (the m64k8 fragment: rows
// g and g + 8 of the warp's 16, fragment columns q and q + 4), b K-major
// in shared memory; d and a are in use until a wgmma wait covers the
// group.  The tensor cores add into d by truncation, so a long sum
// drifts low: d is a stage's partial sum only (see consume).
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc],
                                           const unsigned (&a)[4],
                                           unsigned long long b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep registers in place across the asynchronous window.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(x[e])::"memory");
}
__device__ __forceinline__ void pin(unsigned (&x)[2][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(x[i / 4][i % 4])::"memory");
}

// A barrier of the producer warpgroup alone (named barrier 1).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The producer warpgroup's side of the flags (its first thread spins on
// or raises them); a flag is raised once a launch, to the launch's epoch.
__device__ __forceinline__ void producer_wait_for(int* flag, int epoch,
                                                  int pt) {
  if (pt == 0) {
    wait_epoch<64>(flag, epoch);
    __threadfence_system();
  }
  producer_sync();
}

__device__ __forceinline__ void producer_signal(int* flag, int epoch, int pt) {
  producer_sync();
  if (pt == 0) {
    __threadfence_system();
    Flag(*flag).store(epoch, cuda::std::memory_order_release);
  }
}

// The loaded [kBK, kBN] B tile (N-major) -> its TF32 hi and lo parts,
// K-major in core matrices (core_off with n as the row) in raw_k's depth
// order, by the 128 threads of a warpgroup (t: 0 .. 127).  A thread takes
// one column n at four split rows 4 k4 .. 4 k4 + 3, which raw_k puts at
// loaded rows k4, k4 + 4, k4 + 8, k4 + 12, and stores each part as one
// 16-byte vector: a warp reads 32 banks a row and writes 512 contiguous
// bytes in four conflict-free wavefronts.
__device__ __forceinline__ void split_b(const float* bs, unsigned* hi,
                                        unsigned* lo, int t) {
  static_assert(kBK == 16, "raw_k(4 k4 + j) = 4 j + k4 holds for kBK = 16");
#pragma unroll
  for (int u = t; u < kBN * (kBK / 4); u += 128) {
    const int n = u % kBN, k4 = u / kBN;
    uint4 h, l;
    split_tf32(bs[k4 * kBN + n], h.x, l.x);
    split_tf32(bs[(4 + k4) * kBN + n], h.y, l.y);
    split_tf32(bs[(8 + k4) * kBN + n], h.z, l.z);
    split_tf32(bs[(12 + k4) * kBN + n], h.w, l.w);
    const int o = core_off(n, 4 * k4);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// Where the stages of one hop of one strip come from and go to.
struct Hop {
  int m0;            // the chunk's first row
  int rows;          // valid rows of the chunk
  int k;             // the hop: block k of A_rot
  const float* b;    // block k at the strip's first column
  long long ldb;
  int width;         // valid columns of the strip
  float* fwd;        // the neighbour's block k + 1 at the strip, or null
  long long ldf;
};

// The walk every role of a CTA makes, in one order: the CTA's strips,
// each strip's row chunks, each chunk's d hops, each hop's depth in
// stages of kBK.  A running stage count names each stage's ring slot.
struct Walk {
  int tiles, spt, strips, steps;
  __device__ Walk(const RingMatmul& p)
      : tiles(p.n / p.nt),
        spt((p.nt + kBN - 1) / kBN),
        strips(tiles * spt),
        steps((p.lr + kBK - 1) / kBK) {}
};

template <int W, int TP>
struct Ring {
  float* smem;
  unsigned* split;            // the consumer warpgroups' split buffers of B
  unsigned long long* full;   // [kStages]: the stage's A and B landed
  unsigned long long* empty;  // [kStages]: the consumers are done with it
  __device__ float* stage(int it) const {
    return smem + (it % Tiling<W, TP>::kStages) * Tiling<W, TP>::kStage;
  }
};

// The producer warpgroup: loads stage after stage into the ring (A by
// TMA when p.tma is set, B by cp.async), and kLag stages behind, once
// a stage has landed, forwards its loaded B tile into the neighbour's
// buffer and marks the stage full.  It waits for the ring flags; at the
// end of a hop every loaded stage is published before the hop's flag is
// raised, so it never waits for a flag while it holds stages back.
template <int W, int TP>
struct Producer {
  using Tl = Tiling<W, TP>;
  const RingMatmul& p;
  Ring<W, TP> ring;
  bool vec;
  int pt;  // 0 .. 127
  int it = 0, pub = 0, hop0 = 0;  // stages issued; published; hop's first
  Hop h;

  __device__ void issue() {
    constexpr int S = Tl::kStages;
    if (it >= S) mbar_wait(&ring.empty[it % S], ((it / S) + 1) & 1);
    float* st = ring.stage(it);
    float* bs = st + Tl::kTileA;
    const int k0 = (it - hop0) * kBK;
    const int depth = p.lr;
    const int me = rank_of(p);
    if (p.tma) {
      if (pt == 0) {  // the m64 tiles that hold rows of A
        const int boxes = min(W * TP, (h.rows + 63) / 64);
        mbar_expect(&ring.full[it % S], boxes * 64 * kBK * 4);
#pragma unroll 1
        for (int j = 0; j < boxes; ++j)
          tma_load(st + j * 64 * kBK, &p.amaps[me], k0, h.m0 + j * 64, h.k,
                   &ring.full[it % S]);
      }
    } else {
      const float* a = p.a[me] + static_cast<long long>(h.m0) * p.d * p.lr +
                       static_cast<long long>(h.k) * p.lr;
      const long long lda = static_cast<long long>(p.d) * p.lr;
#pragma unroll 1
      for (int i = pt; i < Tl::kTileA; i += 128) {
        const int r = i / kBK, c = i % kBK;
        st[i] = (r < h.rows && k0 + c < depth) ? a[r * lda + k0 + c] : 0.0f;
      }
      producer_sync();
      if (pt == 0) mbar_arrive(&ring.full[it % S]);
    }
    if (vec) {
      for (int i = pt; i < kBK * (kBN / 4); i += 128) {
        const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
        const bool ok = k0 + r < depth && c < h.width;
        cp_async16(bs + 4 * i, ok ? h.b + (k0 + r) * h.ldb + c : h.b, ok);
      }
    } else {
#pragma unroll 1
      for (int i = pt; i < kBK * kBN; i += 128) {
        const int r = i / kBN, c = i % kBN;
        bs[i] = (k0 + r < depth && c < h.width)
                    ? __ldcg(h.b + (k0 + r) * h.ldb + c)
                    : 0.0f;
      }
    }
    cp_async_commit();
    ++it;
  }

  // Stage ``pub``, whose B tile has landed: forward it, mark the stage
  // full.
  __device__ void publish() {
    const float* bs = ring.stage(pub) + Tl::kTileA;
    producer_sync();  // every thread's copies of the tile are visible
    if (h.fwd != nullptr) {
      const int k0 = (pub - hop0) * kBK;
      const int rows = min(kBK, p.lr - k0);
      float* dst = h.fwd + k0 * h.ldf;
      if (vec) {
        for (int i = pt; i < kBK * (kBN / 4); i += 128) {
          const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
          if (r < rows && c < h.width)
            *reinterpret_cast<float4*>(dst + r * h.ldf + c) =
                *reinterpret_cast<const float4*>(bs + r * kBN + c);
        }
      } else {
#pragma unroll 1
        for (int i = pt; i < kBK * kBN; i += 128) {
          const int r = i / kBN, c = i % kBN;
          if (r < rows && c < h.width) dst[r * h.ldf + c] = bs[r * kBN + c];
        }
      }
    }
    __syncwarp();
    if (pt % 32 == 0) mbar_arrive(&ring.full[pub % Tl::kStages]);
    ++pub;
  }

  __device__ void flush() {
    cp_async_wait<0>();
    while (pub < it) publish();
  }

  __device__ void run() {
    const int d = p.d, me = rank_of(p);
    const int epoch = launch_epoch(p.counter, p.epoch);
    const int dst = ((me + p.dir) % d + d) % d;
    const Walk wk(p);
    const long long arrivals = static_cast<long long>(d) * wk.strips * d;
    int* arrive = p.flags;  // this rank's arrivals are raised upstream
    int* done = arrive + arrivals;
    int* arrive_dst = p.flags_dst;
    int* done_dst = arrive_dst + arrivals;
    const long long blk = static_cast<long long>(p.lr) * p.nt;
    const float* own = d > 1 ? p.buf[me] : nullptr;
    float* next = d > 1 ? p.buf[dst] : nullptr;
    if (p.rank >= 0 && d > 1) {  // the neighbour's buffer is free this launch
      int* ready = done + static_cast<long long>(d) * wk.strips;  // [d]
      int* ready_dst = done_dst + static_cast<long long>(d) * wk.strips;
      if (pt == 0 && blockIdx.x == 0)
        Flag(ready[me]).store(epoch, cuda::std::memory_order_release);
      producer_wait_for(ready_dst + dst, epoch, pt);
    }
    for (int s = blockIdx.x; s < wk.strips; s += gridDim.x) {
      const int t = s / wk.spt;
      const int c0 = (s % wk.spt) * kBN;  // first column within the N tile
      const long long col0 = static_cast<long long>(t) * p.nt + c0;
      const long long slot = static_cast<long long>(t % p.slots) * (d - 1) * blk;
      // the neighbour's slot holds strip s - slots * spt until it is done
      if (d > 1 && s >= p.slots * wk.spt)
        producer_wait_for(&done_dst[static_cast<long long>(dst) * wk.strips + s -
                                    p.slots * wk.spt],
                          epoch, pt);
      h.width = min(kBN, p.nt - c0);
      for (h.m0 = 0; h.m0 < p.m; h.m0 += Tl::kBM) {
        h.rows = min(Tl::kBM, p.m - h.m0);
        for (h.k = 0; h.k < d; ++h.k) {
          if (h.k == 0) {
            h.b = p.b[me] + col0;
            h.ldb = p.n;
          } else {
            // the first chunk waits for the block; later chunks find it
            if (h.m0 == 0) {
              flush();
              producer_wait_for(
                  &arrive[(static_cast<long long>(me) * wk.strips + s) * d + h.k],
                  epoch, pt);
            }
            h.b = own + slot + (h.k - 1) * blk + c0;
            h.ldb = p.nt;
          }
          const bool fwd = h.m0 == 0 && h.k + 1 < d;
          h.fwd = fwd ? next + slot + h.k * blk + c0 : nullptr;
          h.ldf = p.nt;
          hop0 = it;
          for (int step = 0; step < wk.steps; ++step) {
            issue();
            if (it - pub > Tl::kLag) {
              cp_async_wait<Tl::kLag>();
              publish();
            }
          }
          flush();
          if (fwd)
            producer_signal(
                &arrive_dst[(static_cast<long long>(dst) * wk.strips + s) * d + h.k + 1],
                epoch, pt);
        }
      }
      // every read of this rank's buffer for strip s has landed
      if (d > 1)
        producer_signal(&done[static_cast<long long>(me) * wk.strips + s], epoch, pt);
    }
  }
};

// A consumer warpgroup: for every stage, B's TF32 parts split into its
// own buffer; its A fragments from the loaded A tile split into TF32
// parts in registers, and for each of its m64 tiles lo.hi, hi.lo and
// hi.hi into a fresh partial sum, which is then added into acc in f32
// (round to nearest), so the tensor cores' truncation acts on one
// stage's 16-deep sum only.  The sums of all d hops stay in registers
// (block 0, 1, ..., d - 1, k ascending within a block) and C is written
// once.
template <int W, int TP>
__device__ void consume(const RingMatmul& p, const Ring<W, TP>& ring) {
  using Tl = Tiling<W, TP>;
  constexpr int S = Tl::kStages;
  const int me = rank_of(p);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, q = threadIdx.x % 4;
  const Walk wk(p);
  int it = 0;
  for (int s = blockIdx.x; s < wk.strips; s += gridDim.x) {
    const int t = s / wk.spt;
    const int c0 = (s % wk.spt) * kBN;
    const int width = min(kBN, p.nt - c0);
    float* c = p.c[me] + static_cast<long long>(t) * p.nt + c0;
    for (int m0 = 0; m0 < p.m; m0 += Tl::kBM) {
      float acc[TP][kAcc];
#pragma unroll
      for (int tp = 0; tp < TP; ++tp)
#pragma unroll
        for (int e = 0; e < kAcc; ++e) acc[tp][e] = 0.0f;
      for (int step = 0; step < p.d * wk.steps; ++step, ++it) {
        mbar_wait(&ring.full[it % S], (it / S) & 1);
        const float* st = ring.stage(it);
        // this warpgroup's split buffer it % 2: its wgmma group of stage
        // it - 2 has completed on every warp (they all passed the barrier
        // of stage it - 1 after it)
        unsigned* bhi = ring.split + (wg * 2 + it % 2) * 2 * Tl::kTileB;
        unsigned* blo = bhi + Tl::kTileB;
        split_b(st + Tl::kTileA, bhi, blo, threadIdx.x % 128);
        // the split was written through the generic proxy, wgmma reads it
        // through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
        for (int tp = 0; tp < TP; ++tp) {
          if (m0 + (wg * TP + tp) * 64 >= p.m) break;  // a tile of padding rows
          const float* ar = st + ((wg * TP + tp) * 64 + warp * 16 + g) * kBK + 4 * q;
          const float4 u = *reinterpret_cast<const float4*>(ar);
          const float4 v = *reinterpret_cast<const float4*>(ar + 8 * kBK);
          const float x[8] = {u.x, v.x, u.y, v.y, u.z, v.z, u.w, v.w};
          unsigned ah[2][4], al[2][4];  // the two k8 steps
#pragma unroll
          for (int i = 0; i < 8; ++i) split_tf32(x[i], ah[i / 4][i % 4], al[i / 4][i % 4]);
          float part[kAcc];
          pin(part);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kBK / 8; ++ks) {  // small terms first
            const int o = ks * 2 * kCore;
            const unsigned long long bh = desc(bhi + o), bl = desc(blo + o);
            wgmma_tf32(part, al[ks], bh, ks);  // the stage's first product starts the sum
            wgmma_tf32(part, ah[ks], bl, 1);
            wgmma_tf32(part, ah[ks], bh, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          pin(part);
          pin(ah);
          pin(al);
#pragma unroll
          for (int e = 0; e < kAcc; ++e) acc[tp][e] += part[e];
        }
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(&ring.empty[it % S]);
      }
      // acc[tp][4 j + 2 half + e] is row g + 8 half, column 8 j + 2 q + e
      // of this warp's 16 rows of m64 tile wg TP + tp
#pragma unroll
      for (int tp = 0; tp < TP; ++tp) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + (wg * TP + tp) * 64 + warp * 16 + g + half * 8;
          if (row >= p.m) continue;
          float* crow = c + static_cast<long long>(row) * p.n;
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            const int col = j * 8 + 2 * q;
            if (col < width) crow[col] = acc[tp][4 * j + 2 * half];
            if (col + 1 < width) crow[col + 1] = acc[tp][4 * j + 2 * half + 1];
          }
        }
      }
    }
  }
}

template <int W, int TP>
__global__ void __launch_bounds__(Tiling<W, TP>::kThreads, 1)
    ring_matmul_kernel(const __grid_constant__ RingMatmul p) {
  using Tl = Tiling<W, TP>;
  extern __shared__ __align__(1024) float smem[];
  Ring<W, TP> ring;
  ring.smem = smem;
  ring.split = reinterpret_cast<unsigned*>(smem + Tl::kStages * Tl::kStage);
  ring.full = reinterpret_cast<unsigned long long*>(ring.split + Tl::kSplit);
  ring.empty = ring.full + Tl::kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Tl::kStages; ++i) {
      mbar_init(&ring.full[i], 5);  // the A load's arrival, 4 warps' publication
      mbar_init(&ring.empty[i], Tl::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= Tl::kConsumers) {
    const int me = rank_of(p), d = p.d;
    const int dst = ((me + p.dir) % d + d) % d;
    const bool vec =
        ((p.nt | p.n) & 3) == 0 &&
        ((reinterpret_cast<uintptr_t>(p.b[me]) |
          reinterpret_cast<uintptr_t>(d > 1 ? p.buf[me] : nullptr) |
          reinterpret_cast<uintptr_t>(d > 1 ? p.buf[dst] : nullptr)) &
         15) == 0;
    Producer<W, TP> pr{p, ring, vec, static_cast<int>(threadIdx.x) - Tl::kConsumers};
    pr.run();
  } else {
    consume<W, TP>(p, ring);
  }
}

constexpr int kMaxDevices = 64;

// CTAs of ``kernel`` resident on the current device at once, with ``smem``
// bytes of dynamic shared memory each.
int resident_ctas(const void* kernel, int threads, int smem, long long& out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out = static_cast<long long>(per_sm) * sms;
  return 0;
}

// CTAs per rank: as many of the ``resident`` CTAs as each of the d ranks
// that share the card may take, at most ``useful``;
// cudaErrorCooperativeLaunchTooLarge when not even one CTA a rank fits.
int grid_x(long long resident, int d, long long useful, int& gx) {
  long long fit = resident / d;
  if (fit > useful) fit = useful;
  if (fit < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  gx = static_cast<int>(fit);
  return 0;
}

template <int W, int TP>
struct Chunk {
  static constexpr int kW = W, kTP = TP;
};

// f(Chunk<W, TP>{}) for the row chunk of M: the fewest m64 tiles that
// hold M, one consumer warpgroup each, up to 4; above 256 rows chunks of
// 384 on 3 warpgroups of two tiles, tiles wholly past M skipped (five
// warpgroups and the producer would leave a thread too few registers
// for two sets of partial sums).
template <class F>
int by_chunk(int m, F f) {
  switch ((m + 63) / 64) {
    case 1: return f(Chunk<1, 1>{});
    case 2: return f(Chunk<2, 1>{});
    case 3: return f(Chunk<3, 1>{});
    case 4: return f(Chunk<4, 1>{});
    default: return f(Chunk<3, 2>{});
  }
}

// The kernel for p's row chunk and its CTAs per rank when ``share`` ranks
// share the card; its shared memory is granted and its resident CTAs
// counted once a device.
template <int W, int TP>
int matmul_grid(const RingMatmul& p, int share, const void*& kernel, int& gx) {
  using Tl = Tiling<W, TP>;
  static long long resident[kMaxDevices];
  kernel = reinterpret_cast<const void*>(ring_matmul_kernel<W, TP>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tl::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int e = resident_ctas(kernel, Tl::kThreads, Tl::kSmem, resident[dev]);
    if (e != 0) return e;
  }
  const long long strips =
      static_cast<long long>(p.n / p.nt) * ((p.nt + kBN - 1) / kBN);
  return grid_x(resident[dev], share, strips, gx);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// TMA maps of each rank's A_rot [M, d lr] viewed as [d blocks, M, lr]
// (box {kBK, 64, 1}: one m64 tile of one stage) into p.amaps, on the host:
// every rank's (rank < 0, stacked), or rank ``rank``'s alone, from its own
// A.  p.tma stays 0 (no maps) when an A is not 16-byte aligned or lr is
// not a multiple of 4: the kernel then loads A itself.
int encode_amaps(RingMatmul& p) {
  const int r0 = p.rank < 0 ? 0 : p.rank, r1 = p.rank < 0 ? p.d : p.rank + 1;
  bool ok = p.lr > 0 && p.lr % 4 == 0;
  for (int r = r0; r < r1 && ok; ++r) ok = reinterpret_cast<uintptr_t>(p.a[r]) % 16 == 0;
  if (!ok) return 0;
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.lr),
                              static_cast<cuuint64_t>(p.m),
                              static_cast<cuuint64_t>(p.d)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(p.d) * p.lr * 4,
                                 static_cast<cuuint64_t>(p.lr) * 4};
  const cuuint32_t box[3] = {kBK, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  for (int r = r0; r < r1; ++r) {
    if (encode(&p.amaps[r], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
               const_cast<float*>(p.a[r]), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.tma = 1;
  return 0;
}

// The ranks' addresses into p: ``ptrs`` is a host array [4, d] of the
// ranks' A_rot, B, rotating buffer and C (a row an operand).
int fill_ranks(RingMatmul& p, const long long* ptrs, int d) {
  if (d < 1 || d > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < d; ++r) {
    p.a[r] = reinterpret_cast<const float*>(ptrs[r]);
    p.b[r] = reinterpret_cast<const float*>(ptrs[d + r]);
    p.buf[r] = reinterpret_cast<float*>(ptrs[2 * d + r]);
    p.c[r] = reinterpret_cast<float*>(ptrs[3 * d + r]);
  }
  p.d = d;
  return 0;
}

// The launch of p (32 KB: passed by address, copied once, into the launch).
int launch_matmul(RingMatmul& p, int share, cudaStream_t stream) {
  const int err = encode_amaps(p);
  if (err != 0) return err;
  return by_chunk(p.m, [&](auto c) {
    using C = decltype(c);
    using Tl = Tiling<C::kW, C::kTP>;
    const void* kernel = nullptr;
    int gx = 0;
    const int e = matmul_grid<C::kW, C::kTP>(p, share, kernel, gx);
    if (e != 0) return e;
    void* args[] = {&p};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        kernel, dim3(gx, p.rank < 0 ? p.d : 1), dim3(Tl::kThreads), args,
        Tl::kSmem, stream));
  });
}

}  // namespace

// CTAs a rank of K6 may take with d ranks: as many as are resident at
// once (the whole grid must be, since ranks wait on each other);
// cudaErrorCooperativeLaunchTooLarge when not even one a rank fits.
extern "C" int smf_ring_all_gather_ctas(int d, int* ctas) {
  long long resident = 0;
  const int err = resident_ctas(
      reinterpret_cast<const void*>(ring_all_gather_kernel<kPtrsSmall>), kGatherThreads, 0,
      resident);
  return err != 0 ? err : grid_x(resident, d, 1LL << 30, *ctas);
}

// bases: host array of 2 * ops addresses: operand op's input [d, words]
// at [op] (rank r's block at word r * words) and its output [d, d, words]
// at [ops + op] (rank r's blocks at word r * d * words); ctas: CTAs a rank,
// at most smf_ring_all_gather_ctas(d); slice: words a CTA owns of a block,
// a multiple of 4 with ctas * slice >= words; flags: int32[d * (d - 1) *
// ctas], kept across launches on one stream; epoch >= 1, not the epoch of
// the stream's previous launch on ``flags``.  Returns the cudaError_t of
// the launch.
extern "C" int smf_ring_all_gather(const long long* bases, int ops, int d,
                                   long long words, long long slice, int ctas,
                                   int* flags, int epoch, cudaStream_t stream) {
  const int n = ops * d;
  if (ops < 1 || d < 1 || words < 1 || slice < 1 || slice % 4 != 0 || ctas < 1 ||
      epoch < 1 || static_cast<long long>(ctas) * slice < words)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto tag) {
    constexpr int P = decltype(tag)::value;
    Gather<P> p{};
    for (int op = 0; op < ops; ++op) {
      const unsigned* in = reinterpret_cast<const unsigned*>(bases[op]);
      unsigned* out = reinterpret_cast<unsigned*>(bases[ops + op]);
      for (int r = 0; r < d; ++r) {  // each rank's own base pointers
        p.in[op * d + r] = in + r * words;
        p.out[op * d + r] = out + static_cast<long long>(r) * d * words;
      }
    }
    p.flags = flags;
    p.flags_dst = flags;
    p.words = words;
    p.slice = slice;
    p.d = d;
    p.ops = ops;
    p.epoch = epoch;
    p.rank = -1;
    p.hops = d - 1;
    void* args[] = {&p};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(ring_all_gather_kernel<P>), dim3(ctas, d),
        dim3(kGatherThreads), args, 0, stream));
  };
  if (n <= kPtrsSmall) return run(std::integral_constant<int, kPtrsSmall>{});
  if (n <= kPtrsLarge) return run(std::integral_constant<int, kPtrsLarge>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The one-thread advance of ``counter`` after a launch of one rank, on
// the launch's stream (after a failed launch: that launch's error).
static int advance(int err, int* counter, cudaStream_t stream) {
  if (err != 0) return err;
  advance_epoch<<<1, 1, 0, stream>>>(counter);
  return static_cast<int>(cudaGetLastError());
}

// One rank of K6 a launch.  bases: host array of ops + ops * d addresses:
// this rank's block [words] of operand op at [op], and rank r's landing
// buffer of operand op, [hops + 1, words], at [ops + op * d + r] (peer
// pointers but for r = rank; the launch writes rank's and the downstream
// rank's); ctas, slice: as smf_ring_all_gather, the same on every rank
// (ctas at most smf_ring_all_gather_ctas(ranks sharing the card)); flags /
// flags_dst: this rank's and the downstream rank's int32[d * (d - 1) *
// ctas + d], zeroed once; counter: this rank's int32 epoch counter of the
// set (the epoch of its last launch, 0 at first), which every rank
// advances in step; hops: d - 1 (the all-gather: block k from rank
// (rank - k) mod d) or any 1 <= hops < d (blocks 0 .. hops land; 1 is
// ppermute(i -> i + 1)), 0 when d = 1.  Enqueues the launch, then the
// counter's advance.  Returns the cudaError_t of the launches.
extern "C" int smf_ring_all_gather_rank(const long long* bases, int ops, int d,
                                        int rank, long long words, long long slice,
                                        int ctas, int* flags, int* flags_dst,
                                        int* counter, int hops, cudaStream_t stream) {
  const int n = ops * d;
  if (ops < 1 || d < 1 || rank < 0 || rank >= d || words < 1 || slice < 1 ||
      slice % 4 != 0 || ctas < 1 || counter == nullptr || hops > d - 1 ||
      hops < (d > 1 ? 1 : 0) || static_cast<long long>(ctas) * slice < words)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto tag) {
    constexpr int P = decltype(tag)::value;
    Gather<P> p{};
    for (int op = 0; op < ops; ++op) {
      p.in[op * d + rank] = reinterpret_cast<const unsigned*>(bases[op]);
      for (int r = 0; r < d; ++r)
        p.out[op * d + r] = reinterpret_cast<unsigned*>(bases[ops + op * d + r]);
    }
    p.flags = flags;
    p.flags_dst = flags_dst;
    p.counter = counter;
    p.words = words;
    p.slice = slice;
    p.d = d;
    p.ops = ops;
    p.rank = rank;
    p.hops = hops;
    void* args[] = {&p};
    return advance(static_cast<int>(cudaLaunchCooperativeKernel(
                       reinterpret_cast<const void*>(ring_all_gather_kernel<P>), dim3(ctas, 1),
                       dim3(kGatherThreads), args, 0, stream)),
                   counter, stream);
  };
  if (n <= kPtrsSmall) return run(std::integral_constant<int, kPtrsSmall>{});
  if (n <= kPtrsLarge) return run(std::integral_constant<int, kPtrsLarge>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// ptrs: host array [4, d] of the ranks' addresses (1 <= d <= kMaxRanks):
// A_rot [m, d * lr] with block k = owner (me - k) mod d, B [lr, n], a
// [(d - 1) * lr * n] scratch buffer (0 when d = 1), C [m, n]; flags:
// zeroed int32[d * strips * (d + 1)], strips = ceil(n / 64).  K7: one N
// tile, blocks flow right.
extern "C" int smf_ring_matmul(const long long* ptrs, int* flags, int d, int m, int lr,
                               int n, cudaStream_t stream) {
  RingMatmul p{};
  const int err = fill_ranks(p, ptrs, d);
  if (err != 0) return err;
  p.flags = p.flags_dst = flags;
  p.m = m, p.lr = lr, p.n = n, p.nt = n, p.slots = 1, p.dir = 1, p.rank = -1;
  p.epoch = 1;
  return launch_matmul(p, d, stream);
}

// As smf_ring_matmul over n / nt column tiles (n % nt == 0), blocks
// flowing left (A_rot block k = owner (me + k) mod d); a rank's buffer:
// [slots * (d - 1) * lr * nt], tile t in slot t % slots (slots >= 1);
// flags: zeroed int32[d * strips * (d + 1)], strips = (n / nt) *
// ceil(nt / 64).  K8.
extern "C" int smf_ring_matmul_tiled(const long long* ptrs, int* flags, int d, int m,
                                     int lr, int n, int nt, int slots,
                                     cudaStream_t stream) {
  if (nt <= 0 || n % nt != 0 || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RingMatmul p{};
  const int err = fill_ranks(p, ptrs, d);
  if (err != 0) return err;
  p.flags = p.flags_dst = flags;
  p.m = m, p.lr = lr, p.n = n, p.nt = nt, p.slots = slots, p.dir = -1, p.rank = -1;
  p.epoch = 1;
  return launch_matmul(p, d, stream);
}

// One rank of K7 (dir = 1, nt = n, slots = 1) or K8 (dir = -1) a launch.
// ptrs: as in the stacked entries, of which the launch reads this rank's
// A_rot, B and C (the other ranks' may be 0), its buffer and the
// downstream rank's, (rank + dir) mod d (a peer pointer); A's TMA map is
// built from this rank's A alone.  flags / flags_dst: this rank's and the
// downstream rank's int32[d * strips * (d + 1) + d], zeroed once; share:
// the ranks that share this card (the grid takes 1 / share of its
// resident CTAs); counter: as smf_ring_all_gather_rank's.  Enqueues the
// launch, then the counter's advance.
extern "C" int smf_ring_matmul_rank(const long long* ptrs, int* flags, int* flags_dst, int d,
                                    int m, int lr, int n, int nt, int slots, int dir,
                                    int rank, int share, int* counter, cudaStream_t stream) {
  if (nt <= 0 || n % nt != 0 || slots < 1 || (dir != 1 && dir != -1) || rank < 0 ||
      rank >= d || share < 1 || counter == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  RingMatmul p{};
  const int err = fill_ranks(p, ptrs, d);
  if (err != 0) return err;
  p.flags = flags;
  p.flags_dst = flags_dst;
  p.counter = counter;
  p.m = m, p.lr = lr, p.n = n, p.nt = nt, p.slots = slots, p.dir = dir, p.rank = rank;
  return advance(launch_matmul(p, share, stream), counter, stream);
}
