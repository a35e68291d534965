// Flag-handoff line step: the body of the 2D substitution kernels on Hopper
//
//     flow_kernel<R, false, S, SPLIT>       forward pass          thomas_fwd.cu
//     flow_kernel<R, true,  S, SPLIT>       backward pass         thomas_bwd.cu
//     cached_kernel<R, kBanded, S, SPLIT>   cached forward pass   thomas_fwd_cached.cu
//                                           (dense or banded+tail pivots)
//     pass_map_kernel<R, true, kBf16, true, SPLIT>
//                                           backward pass on      thomas_bwd.cu
//                                           banded+tail pivots
//     sweep::down_kernel<R, SPLIT>,         whole Gauss-Seidel    sweep_fused.cu
//     sweep::up_kernel<R, SPLIT>            sweep directions
//
// on bf16 or int8 pivot planes (S).  The dense passes run flow_kernel, the
// others run_flow, the same step driven by a step map (the second half of
// this file, which says what it adds).  thomas_line.cuh describes the
// layouts, the numerics contract and the bound; the step computes
//
//     w = rhs_j [+- cpl . trace] - band_j . prev,     t = C_j^{-1} w,
//
// bf16 or int8 planes widened to f32, f32 carries, bands and sums.
//
// Why this step.  A line of the grid-barrier step these kernels ran before
// took 4.5 us at n = 801 against 0.78 us of bytes (PERF.md §5-6): it ended in
// a grid barrier (a fence, an atomic and a spin through L2), only then did
// all blocks issue a second L2 round trip for the whole carry, and each block
// recomputed the band step for all n lanes and reduced all n input rows with
// 128 threads.  Here a line waits on latency, so the step is built to
// shorten the chain from one line's last product to the next line's first
// (PERF.md §6 measures each point):
//
// 1. Hand the carry over with flags, not a grid barrier.  The producer of a
//    tile publishes its sums for its 8 output lanes of each row as 8-byte
//    words (value, flag) in an exchange buffer, the low-latency form of
//    NCCL's LL protocol: an aligned 8-byte store is seen whole or not at all,
//    so a consumer that reads a word whose flag matches has its value, and
//    the wait and the carry read are one L2 round trip.  A CTA's threads read
//    the words of the lanes its rows need, i0 - 1 .. i0 + cnt, together, 16
//    bytes a load, consecutive threads on consecutive words, with relaxed
//    loads at GPU scope (past the incoherent L1); they poll again, all
//    missing words in one batch, until every flag matches, write the carry
//    into shared memory, and meet at one barrier of the block before the
//    band step.  A CTA that takes several tiles of one batch row and line in
//    turn reads their carry once, and forms their w once: w depends on the
//    batch row and the line only, so each thread keeps w of its rows in
//    registers, and the later tiles' stages carry no band or right-hand rows.
//      The flag of line step k is epoch + k.  The epoch comes from the
//    wrapper's launch counter (thomas_kernels.py, Exchange), which hands each
//    launch `count` fresh values of a counter that only grows, in a buffer
//    that only these kernels write and that was zeroed when it was made: no
//    stale word can carry a current flag, and no memset runs per launch.  (On
//    the counter's wrap-around the wrapper zeroes the buffer once.)  The
//    buffer is a ring of kSlots = 4 lines of (B, ld, 2r, SPLIT) words.
//    Spinning needs every block resident: the launch is cooperative, with
//    the grid sized by occupancy, so a launch that does not fit is refused.
//
// 2. Work split.  A tile's CTA holds 512 threads, one CTA an SM.  Lines
//    whose stage buffers do not fit one CTA split each tile's input rows
//    across two CTAs of 256 threads (SPLIT = 2): rank c owns the rows of
//    tiles [c, c + 1) x ceil(T / 2) (T = ld / 8 tiles), stages only its
//    slice's plane rows, band and right-hand rows, reads only the carry
//    lanes of its slice, and publishes its own partial sums of the tile's 8
//    lanes; the consumer reads both halves' words of a row in one load and
//    adds them in rank order.  No atomics, so a pass is bit-identical from
//    run to run.  Two CTAs a tile on every line, 202 CTAs on the 132 SMs at
//    B = 1, n = 801, measured slower than one (PERF.md §6): an SM that holds
//    two CTAs carries a whole tile's rows, and the carry's reads double.  So
//    did a first version that added the halves in rank 0 through distributed
//    shared memory with a cluster barrier per line (a cooperative launch with
//    a cluster dimension, which the H100 accepts): the barrier cost about 0.8
//    us a line.  The reduction inside a warp is a transpose-reduce: each
//    shuffle round halves the values a lane holds (2r x 8 values in log2
//    rounds of 8r + ... + 1 shuffles instead of 5 x 2r x 8); the warps' sums
//    meet in shared memory, and the last warp adds and publishes them.
//      Why four lines in the ring.  A CTA waits on the tiles of its own
//    slice only, but two slices overlap (the tiles next to the split feed
//    both), so a CTA that publishes line k + 2 has seen line k + 1 from a tile
//    that had seen line k from every tile of the batch row; every tile had
//    then read line k - 1, and a write into the slot of line k + 2 - 4 finds
//    no reader left.  (With one CTA a tile every tile reads every tile: two
//    lines would do.)
//
// 3. Take plane staging off the threads and further ahead.  A slice's plane
//    run is contiguous in the tile-major layout (cnt x 16 B in bf16, x 8 B in
//    int8), and so are its rows of the band and of the right-hand side (a
//    whole line's band rows and right-hand rows too).  One thread issues a
//    cp.async.bulk copy per run into a ring of kStages = 3 stage buffers,
//    each completing on its own mbarrier, kStages - 1 items ahead of the one
//    being computed; the other threads only wait on the barrier.  A refill is
//    issued once the item's carry is in, so that its copies do not queue
//    ahead of the carry's loads.
//
// Several tiles a CTA.  At B = 16 (1616 tiles) a CTA (or pair) takes a run of
// consecutive tiles of a line in turn before the next line; every wait is on
// the line before, and every tile of a line is handled by a resident CTA, so
// nothing waits on a later line.  Tiles of different batch rows read
// different words and never wait on each other.  x (backward) and y
// (forward) of a tile's lanes are written by the CTA whose slice holds them:
// y as w is formed, x from the carry it reads one line later (the last
// line's after the loop).
//
// Wide batches.  On dense planes a launch takes r = 1, 2, 4 or 8 right-hand
// sides (the wrappers pad r = 3 to 4 and r = 5..7 to 8 with zero columns, and
// run more than 8 as groups of 8), so that each pivot plane is read once for
// the whole batch, as the TPU kernels do for any r (pallas_thomas.py,
// _solve_cached_multi).  r = 1 and 2 keep the step above unchanged.  Wider,
// a thread's partial sums of all 2r x 8 outputs and w of its rows (wk) would
// not fit the 128 registers a thread has; a first version that kept w in
// shared memory and took f32 products a pair of right-hand sides at a time
// spent 4.5 of a 12.5 us line step on its products and needed two CTAs a
// tile at n = 801 (its stage buffers carried 16 right-hand rows), which
// doubles the carry's words (thomas_ablation.py --r 8, PERF.md §6).  So at
// r = 4 and 8:
//   - a thread copies the right-hand and band rows of its rows of the line
//     straight into w and a band buffer in shared memory (cp.async, 4 bytes
//     each, while the carry is polled) and forms w there; the stage buffers
//     carry the plane runs only, so a line up to 848 lanes takes one CTA a
//     tile at r = 8;
//   - each warp multiplies 64-row segments of the staged plane run by w on
//     tensor cores (wide_mma.cuh: mma.sync m16n8k16, w split into three bf16
//     terms, f32 sums; a warp ends with 8 sums a lane, stored on the warps'
//     sums as before), after a barrier of the block (a segment holds other
//     threads' rows of w);
//   - the carry's words are polled 16 a thread at once (poll_strided).
//
// Limits.  r = 1, 2, 4 or 8 on dense planes (1 or 2 on banded+tail pivots and
// in the fused sweeps), and a slice whose kStages stage buffers fit in one
// CTA's shared memory and whose rows fit flow_groups rows a thread: one CTA a
// tile up to n = 976 in bf16 at r = 2, two up to n = 1968 in bf16 and 2448 in
// int8, the cached forward pass and the backward pass on banded+tail pivots
// (step maps without the trace rows) too; the fused sweeps, which keep the
// trace rows beside the carry, 912 and 1840; at r = 8 one CTA a tile up to
// n = 848 in bf16, two up to 1760 in bf16 and 2144 in int8, at r = 4 up to
// 2448 and 2560 (test_longest_line_fits; the Python mirror is
// thomas_kernels.line_fits).  Anything else is refused with
// cudaErrorInvalidValue before a launch, and a cooperative launch that does
// not fit returns its error.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "thomas_line.cuh"
#include "wide_mma.cuh"

namespace thomas {

// CTAs a tile: the launcher takes two where a whole line's stage buffers do
// not fit one, else one; a build with -DTHOMAS_SPLIT=1 or 2 forces it
// (benchmarks_torch/thomas_probe.py compares the two)
#ifndef THOMAS_SPLIT
#define THOMAS_SPLIT 0
#endif
static_assert(THOMAS_SPLIT >= 0 && THOMAS_SPLIT <= 2, "automatic, one or two CTAs a tile");
// threads of a CTA: 512 with one CTA a tile (a whole line's rows, one CTA an
// SM), 256 with two (two or three CTAs an SM); 128 registers a thread either way
template <int SPLIT>
__host__ __device__ constexpr int flow_threads() {
  return SPLIT == 1 ? 512 : 256;
}
// row groups of a thread (a slice holds at most flow_groups x threads rows):
// a thread keeps w of its rows in registers while the items share it
template <int SPLIT>
__host__ __device__ constexpr int flow_groups() {
  return SPLIT == 1 ? 3 : 5;
}
// stage buffers: kStages - 1 items ahead (-DTHOMAS_STAGES=2 for one)
#ifndef THOMAS_STAGES
#define THOMAS_STAGES 3
#endif
constexpr int kStages = THOMAS_STAGES;
static_assert(kStages >= 2, "a stage being computed and one in flight at least");

// Timing by ablation (benchmarks_torch/thomas_ablation.py): a build with
// -DTHOMAS_ABLATE=<mask> leaves single phases of a line step out: the carry's
// load (with or without the band step), the products, the bulk copies of the
// planes or of the band and right-hand rows, the flag wait (the words are
// read once, flags unchecked).  Its results are wrong and only its time is
// read; the package always builds with 0.
#ifndef THOMAS_ABLATE
#define THOMAS_ABLATE 0
#endif
constexpr bool kNoBandStep = THOMAS_ABLATE & 1;     // neither carry load nor band step
constexpr bool kNoProducts = THOMAS_ABLATE & 2;
constexpr bool kNoPlaneCopies = THOMAS_ABLATE & 8;
constexpr bool kNoRowCopies = THOMAS_ABLATE & 16;   // band and right-hand rows
constexpr bool kNoCarryLoad = THOMAS_ABLATE & 32;
constexpr bool kNoFlagWait = THOMAS_ABLATE & 64;

// Timing by trace (benchmarks_torch/thomas_ablation.py): a build with
// -DTHOMAS_TRACE=1 has one thread of each CTA stamp the SM's cycle counter at
// each phase of items kTraceFirst .. + kTraceItems, and the global timer (ns)
// when the carry is in and when the tile is published, into g_trace, which
// thomas_fwd.cu exports; the package builds without it.
#ifndef THOMAS_TRACE
#define THOMAS_TRACE 0
#endif
constexpr int kTraceCtas = 264, kTraceItems = 64, kTracePoints = 8, kTraceFirst = 200;
#if THOMAS_TRACE
__device__ long long g_trace[kTraceCtas][kTraceItems][kTracePoints];
#endif

// --- PTX helpers ------------------------------------------------------------

// point k of item q, by thread `who`: item start, stage landed, carry in,
// products done, warps' sums in shared memory, tile published (cycles); at
// points 2 and 5 also the global timer, into slots 6 and 7
__device__ __forceinline__ void trace_point(int q, int k, int who = 0) {
#if THOMAS_TRACE
  if ((int)threadIdx.x == who && blockIdx.x < kTraceCtas && q >= kTraceFirst &&
      q < kTraceFirst + kTraceItems) {
    long long* at = g_trace[blockIdx.x][q - kTraceFirst];
    at[k] = clock64();
    if (k == 2 || k == 5) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
      at[k == 2 ? 6 : 7] = t;
    }
  }
#endif
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to this
// CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The L1 line of p fetched ahead of its load
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// Global stores of this thread made visible to the bulk copies (the async
// proxy) that a later barrier orders after them
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Exchange words (value bits, flag): relaxed accesses at GPU scope, which
// go to L2 (past the incoherent L1).  A consumer reads two words at a time,
// 16 bytes, each 8-byte half stored whole by its producer.
__device__ __forceinline__ uint4 ld_words(const uint2* p) {
  uint4 v;
  asm volatile("ld.relaxed.gpu.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_word(uint2* p, float v, unsigned flag) {
  asm volatile("st.relaxed.gpu.global.v2.u32 [%0], {%1, %2};\n" ::"l"(p), "r"(__float_as_uint(v)),
               "r"(flag)
               : "memory");
}

__device__ __forceinline__ bool words_ready(const uint4& v, unsigned want) {
  return v.y == want && v.w == want;
}

// Loads the 16-byte words at ptr[0..K) (nullptr: none) and polls again, all
// missing ones in one batch, until every flag is `want`.  A wait longer than
// any line can take (2^24 polls, seconds) means a producer will never
// publish: the kernel traps, and the launch fails instead of holding the card.
template <int K, bool kWait>
__device__ __forceinline__ void poll_words(const uint2* const (&ptr)[K], uint4 (&v)[K],
                                           unsigned want) {
#pragma unroll
  for (int u = 0; u < K; ++u) v[u] = ptr[u] ? ld_words(ptr[u]) : make_uint4(0u, want, 0u, want);
  if (!kWait) return;
  for (unsigned polls = 0;; ++polls) {
    bool ready = true;
#pragma unroll
    for (int u = 0; u < K; ++u) ready = ready && words_ready(v[u], want);
    if (ready) return;
    if (polls > (1u << 24)) __trap();
#pragma unroll
    for (int u = 0; u < K; ++u)
      if (!words_ready(v[u], want)) v[u] = ld_words(ptr[u]);
  }
}

// poll_words over the words base + 2 (first + u step), u < K, that lie below
// `words` (the others read as ready), their addresses computed again at each
// poll instead of kept in registers: a wide batch polls 16 words a thread at
// once
template <int K, bool kWait>
__device__ __forceinline__ void poll_strided(const uint2* base, int first, int step, int words,
                                             uint4 (&v)[K], unsigned want) {
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int w = first + u * step;
    v[u] = w < words ? ld_words(base + 2 * (size_t)w) : make_uint4(0u, want, 0u, want);
  }
  if (!kWait) return;
  for (unsigned polls = 0;; ++polls) {
    bool ready = true;
#pragma unroll
    for (int u = 0; u < K; ++u) ready = ready && words_ready(v[u], want);
    if (ready) return;
    if (polls > (1u << 24)) __trap();
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int w = first + u * step;
      if (w < words && !words_ready(v[u], want)) v[u] = ld_words(base + 2 * (size_t)w);
    }
  }
}

// Sum of v[0..V) over the warp's 32 lanes by transpose-reduce: each round
// trades half the values with the lane O apart and keeps the other half, so
// after log2(V) rounds lane L holds the sum of value L / (32 / V) (lanes
// L and L ^ 1 alike when V = 16).  V is 16 or 32; C values are left.
template <int O, int C, int V>
__device__ __forceinline__ void transpose_round(float (&v)[V], int lane) {
  if constexpr (O >= 1) {
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      transpose_round<O / 2, H, V>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      transpose_round<O / 2, 1, V>(v, lane);
    }
  }
}

template <int V>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[V]) {
  transpose_round<16, V, V>(v, threadIdx.x & 31);
  return v[0];
}

// --- shared memory ------------------------------------------------------------

// Rows of the largest slice (a multiple of 8)
template <int SPLIT>
__host__ __device__ constexpr int slice_rows(int ld) {
  return kLanes * ((ld / kLanes + SPLIT - 1) / SPLIT);
}

// Wide batches (r = 4, 8; note above)
template <int R>
__host__ __device__ constexpr bool wide() {
  return R > 2;
}

// One stage buffer of a slice of cmax rows: the two plane runs (16 B a row in
// bf16, 8 B in int8), the int8 scales of the tile, and, r <= 2, the 6 band
// rows and the 2R right-hand rows of the slice (wide batches copy those
// straight into their rows of w and of the band, below)
template <int R, Storage S>
__host__ __device__ constexpr size_t flow_stage_bytes(int cmax, int ld) {
  return (size_t)2 * cmax * (S == Storage::kInt8 ? 8 : 16) + scale_buf_bytes<S>(ld) +
         (wide<R>() ? 0 : sizeof(float) * (size_t)(6 + 2 * R) * cmax);
}

// Floats of the carry rows: [2R][cmax + 16], lanes i0 - 8 .. i0 + cmax + 8
template <int R>
__host__ __device__ constexpr size_t flow_prev_bytes(int cmax) {
  return sizeof(float) * 2 * R * (size_t)(cmax + 16);
}

// mbarriers (64 B), the warps' sums [2 parities][warps][2R x 8], the carry
// rows, then the stage ring
// The warps' sums of a tile's 2R x 8 values, value-major: a value's row
// holds its warps' sums side by side (padded to a multiple of 4 floats, off
// the banks of the next row), so that the publisher reads them 16 bytes a load
template <int SPLIT>
__host__ __device__ constexpr int red_pitch() {
  return flow_threads<SPLIT>() / 32 + 4;
}

template <int R, int SPLIT>
__host__ __device__ constexpr size_t flow_red_bytes() {
  return sizeof(float) * 2 * 2 * R * kLanes * red_pitch<SPLIT>();
}

// Wide batches: w of the slice's rows, [2R][cmax], then the 6 band rows of the
// line, [6][cmax]; a thread copies its rows of both in (cp.async) and forms
// its rows of w there, and every warp reads w for its products
template <int R>
__host__ __device__ constexpr size_t flow_w_bytes(int cmax) {
  return wide<R>() ? sizeof(float) * (2 * R + 6) * (size_t)cmax : 0;
}

// 4 bytes global -> this thread's shared memory, asynchronously (the
// right-hand and band rows of a wide batch's w, while the carry is polled)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int R, Storage S, int SPLIT>
__host__ __device__ constexpr size_t flow_smem_bytes(int ld) {
  return 64 + flow_red_bytes<R, SPLIT>() + flow_prev_bytes<R>(slice_rows<SPLIT>(ld)) +
         flow_w_bytes<R>(slice_rows<SPLIT>(ld)) +
         kStages * flow_stage_bytes<R, S>(slice_rows<SPLIT>(ld), ld);
}

// 16-byte exchange words a thread polls at once: all of its words at n = 801
// for r <= 2; 16 for wide batches (poll_strided: two rounds of the 26 words a
// thread reads at r = 8 with two CTAs a tile, one of the 7 at n = 401)
template <int R, int SPLIT>
__host__ __device__ constexpr int poll_batch() {
  return R > 2 ? 16 : (SPLIT == 1 ? 2 : 4) * R;
}

// --- the pass -----------------------------------------------------------------

constexpr int kSlots = 4;              // lines of the exchange ring

struct FlowArgs {
  PassArgs a;              // operands (dense layout)
  uint2* xchg;             // (kSlots, B, ld, 2r, SPLIT) exchange words (value, flag)
  unsigned epoch;          // flag of the pass's first line step
};

template <int R, bool kBackward, Storage S, int SPLIT>
__global__ void __launch_bounds__(flow_threads<SPLIT>(), 512 / flow_threads<SPLIT>())
    flow_kernel(const FlowArgs fa) {
  constexpr int kSplit = SPLIT;         // CTAs a tile
  constexpr int kFlowThreads = flow_threads<SPLIT>();
  constexpr int kFlowWarps = kFlowThreads / 32;
  constexpr int V = 2 * R * kLanes;     // output values of a tile: rows x lanes
  constexpr int NW = kSplit * R;        // 16-byte words a lane: 2R rows x kSplit halves
  constexpr int kPollBatch = poll_batch<R, SPLIT>();
  constexpr bool kWide = wide<R>();
  const PassArgs a = fa.a;
  const int n = a.n, ld = a.ld, m = a.m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)blockIdx.x % kSplit;
  const int pair = (int)blockIdx.x / kSplit;
  const int npairs = (int)gridDim.x / kSplit;

  // this CTA's slice of input rows: i0 .. i0 + cnt - 1
  const int T = ld / kLanes;
  const int cmax = slice_rows<kSplit>(ld);
  const int i0 = rank * cmax;
  const int ilim = min(i0 + cmax, T * kLanes);       // end of the slice's tiles
  const int cnt = max(min(ilim, n) - i0, 0);
  // the carry lanes it reads, lo .. hi - 1: i0 - 1 .. i0 + cnt within [0, n)
  // (an empty half, at n <= 8, reads one lane, so that it keeps in step)
  int lo = max(i0 - 1, 0), hi = min(i0 + cnt + 1, n);
  if (hi <= lo) {
    lo = max(min(i0, n) - 1, 0);
    hi = lo + 1;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);               // [kStages]
  float* red = reinterpret_cast<float*>(smem + 64);                   // warps' sums
  float* s_prev = reinterpret_cast<float*>(smem + 64 + flow_red_bytes<R, SPLIT>());
  const int pp = cmax + 16;                                          // its row pitch
  // wide batches: w of the slice's rows, [2R][cmax], and the band rows [6][cmax]
  float* s_w = reinterpret_cast<float*>(smem + 64 + flow_red_bytes<R, SPLIT>() +
                                        flow_prev_bytes<R>(cmax));
  float* s_bw = s_w + 2 * R * cmax;
  unsigned char* ring = smem + 64 + flow_red_bytes<R, SPLIT>() + flow_prev_bytes<R>(cmax) +
                        flow_w_bytes<R>(cmax);
  const size_t stage_bytes = flow_stage_bytes<R, S>(cmax, ld);
  const size_t pbytes = (size_t)cmax * (S == Storage::kInt8 ? 8 : 16);

  // work items: a run of consecutive tiles (batch row-major) of each line in
  // turn, so that tiles of one batch row share the carry the CTA reads
  const int tiles_row = T;
  const int total = a.batch * tiles_row;
  const int tiles_blk = total / npairs + (pair < total % npairs);
  const int tile0 = pair * (total / npairs) + min(pair, total % npairs);
  const int nitem = a.count * tiles_blk;
  const size_t row = (size_t)2 * R * ld;       // floats per (batch row, line)

  struct Item {
    int k, b, t, j, s;
  };
  auto item = [&](int q) {
    Item it;
    it.k = q / tiles_blk;
    const int tile = tile0 + (q - it.k * tiles_blk);
    it.b = tile / tiles_row;
    it.t = tile - it.b * tiles_row;
    it.j = kBackward ? a.first - it.k : a.first + it.k;
    it.s = __ldg(a.s_idx + it.b);
    return it;
  };
  // the exchange words of line step k, batch row b (lane-major)
  auto slot = [&](int k, int b) {
    return fa.xchg + ((size_t)(k & (kSlots - 1)) * a.batch + b) * ld * NW * 2;
  };
  // the backward pass's x row of line step k
  auto x_row = [&](int k, int b) {
    const int j = a.first - k;
    return a.out + ((size_t)b * a.count + (j - (a.first - a.count + 1))) * row;
  };
  // the carry of line step k: both halves' words of lanes lo .. hi - 1,
  // polled by all threads together, added in rank order into s_prev
  auto load_carry = [&](int k, int b) {
    const uint2* src = slot(k, b);
    const unsigned want = fa.epoch + (unsigned)k;
    const int words = (hi - lo) * NW;
    if constexpr (kWide) {
      const int nw = kNoCarryLoad ? 0 : words;
      for (int w0 = 0; w0 < nw; w0 += kFlowThreads * kPollBatch) {
        uint4 v[kPollBatch];
        poll_strided<kPollBatch, !kNoFlagWait>(src + (size_t)lo * NW * 2, w0 + tid,
                                                kFlowThreads, nw, v, want);
#pragma unroll
        for (int u = 0; u < kPollBatch; ++u) {
          const int w = w0 + tid + u * kFlowThreads;
          if (w >= nw) continue;
          const int at = lo + w / NW - (i0 - 8), h = w % NW;
          if (kSplit == 2) {
            s_prev[h * pp + at] = __uint_as_float(v[u].x) + __uint_as_float(v[u].z);
          } else {
            s_prev[2 * h * pp + at] = __uint_as_float(v[u].x);
            s_prev[(2 * h + 1) * pp + at] = __uint_as_float(v[u].z);
          }
        }
      }
    } else {
      for (int w0 = 0; w0 < words; w0 += kFlowThreads * kPollBatch) {
        const uint2* ptr[kPollBatch];
#pragma unroll
        for (int u = 0; u < kPollBatch; ++u) {
          const int w = w0 + tid + u * kFlowThreads;
          ptr[u] = w < words && !kNoCarryLoad ? src + ((size_t)lo * NW + w) * 2 : nullptr;
        }
        uint4 v[kPollBatch];
        poll_words<kPollBatch, !kNoFlagWait>(ptr, v, want);
#pragma unroll
        for (int u = 0; u < kPollBatch; ++u) {
          if (ptr[u] == nullptr) continue;
          const int w = w0 + tid + u * kFlowThreads;
          const int at = lo + w / NW - (i0 - 8), h = w % NW;
          if (kSplit == 2) {        // word h: row h, halves 0 and 1
            s_prev[h * pp + at] = __uint_as_float(v[u].x) + __uint_as_float(v[u].z);
          } else {                  // words 2h, 2h + 1: rows 2h, 2h + 1
            s_prev[2 * h * pp + at] = __uint_as_float(v[u].x);
            s_prev[(2 * h + 1) * pp + at] = __uint_as_float(v[u].z);
          }
        }
      }
    }
  };

  // the operands of item q that do not depend on the carry, into stage q %
  // kStages (one thread)
  auto stage = [&](int q) {
    const Item it = item(q);
    // an item of the same batch row and line as the one before uses its w:
    // no band or right-hand rows (wide batches copy those in themselves)
    const bool new_w = !kWide && !kNoRowCopies &&
                       (q == 0 || item(q - 1).k != it.k || item(q - 1).b != it.b);
    unsigned char* st = ring + (size_t)(q % kStages) * stage_bytes;
    uint64_t* bar = full + q % kStages;
    const size_t tile = ((size_t)it.s * m + it.j) * T + it.t;
    const unsigned plane_bytes = S == Storage::kInt8 ? 8u * ((cnt + 1) & ~1) : 16u * cnt;
    // a whole line's slice (one CTA a tile) takes its 6 band rows and its 2R
    // right-hand rows in one copy each: they lie back to back at pitch ld
    const bool whole = cmax == ld;
    const unsigned row_bytes = whole ? 4u * ld : 4u * ((cnt + 3) & ~3);
    const unsigned nsc = (unsigned)scale_buf_bytes<S>(ld);
    unsigned bytes = 0;
    if (!kNoPlaneCopies) bytes += 2 * plane_bytes + nsc;
    if (new_w) bytes += (6 + 2 * R) * row_bytes;
    if (cnt == 0) bytes = 0;
    mbar_expect_tx(bar, bytes);
    if (bytes == 0) return;
    const size_t off = (tile * ld + i0) * kLanes * (S == Storage::kInt8 ? 1 : 2);
    float* rows = reinterpret_cast<float*>(st + 2 * pbytes + nsc);
    if (!kNoPlaneCopies) {
      bulk_copy(st, static_cast<const unsigned char*>(a.cre) + off, plane_bytes, bar);
      bulk_copy(st + pbytes, static_cast<const unsigned char*>(a.cim) + off, plane_bytes, bar);
      if (S == Storage::kInt8)
        bulk_copy(st + 2 * pbytes, a.scale + tile * (nsc / sizeof(float)), nsc, bar);
    }
    if (new_w) {
      const float* band = a.band + ((size_t)it.s * m + it.j) * 6 * ld + i0;
      const float* rhs = a.rhs + ((size_t)it.b * m + it.j) * row + i0;
      if (whole) {
        bulk_copy(rows, band, 6 * row_bytes, bar);
        bulk_copy(rows + 6 * cmax, rhs, 2 * R * row_bytes, bar);
      } else {
        for (int d = 0; d < 6; ++d) bulk_copy(rows + d * cmax, band + d * ld, row_bytes, bar);
        for (int p = 0; p < 2 * R; ++p)
          bulk_copy(rows + (6 + p) * cmax, rhs + p * ld, row_bytes, bar);
      }
    }
  };
  // the warp that issues the copies, and the one that adds the warps' sums
  // and publishes: the two with the fewest rows
  constexpr int kStager = kFlowWarps - 2, kPublisher = kFlowWarps - 1;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * R * pp; i += kFlowThreads) s_prev[i] = 0.f;   // lanes never read
  __syncthreads();
  // items 0 .. kStages - 2 now; item q + kStages - 1 once item q has its carry
  if (tid == kStager * 32)
    for (int q = 0; q < kStages - 1 && q < nitem; ++q) stage(q);

  int have_k = -1, have_b = -1;         // the carry in s_prev: line step, batch row
  constexpr int kGroups = flow_groups<SPLIT>();
  float wk[kGroups][2 * R];             // w of this thread's rows, of line step w_k
  int w_k = -1, w_b = -1;               //   and batch row w_b
  for (int q = 0; q < nitem; ++q) {
    const Item it = item(q);
    const int o0 = it.t * kLanes;
    const bool own_tile = o0 >= i0 && o0 < ilim;    // the tile's lanes lie in this slice
    const bool carry_in = it.k > 0 && !kNoBandStep;
    const unsigned char* st = ring + (size_t)(q % kStages) * stage_bytes;
    const unsigned char* pre = st;
    const unsigned char* pim = st + pbytes;
    const float* sc = reinterpret_cast<const float*>(st + 2 * pbytes);
    const float* s_band = reinterpret_cast<const float*>(st + 2 * pbytes +
                                                         scale_buf_bytes<S>(ld));
    const float* s_rhs = s_band + 6 * cmax;
    float* kept = kBackward ? nullptr : a.kept + ((size_t)it.b * m + it.j) * row;

    trace_point(q, 0);
    mbar_wait(full + q % kStages, (unsigned)(q / kStages) & 1u);
    trace_point(q, 1);
    if constexpr (kWide) {
      // a new w: this thread's rows of the right-hand and band rows, copied
      // into w and the band buffer while the carry is polled (every warp is
      // past the products of the item before: s_w is free)
      if (!(it.k == w_k && it.b == w_b) && !kNoRowCopies) {
        const float* band = a.band + ((size_t)it.s * m + it.j) * 6 * ld + i0;
        const float* rhs = a.rhs + ((size_t)it.b * m + it.j) * row + i0;
        for (int il = tid; il < cnt; il += kFlowThreads) {
#pragma unroll
          for (int p = 0; p < 2 * R; ++p) cp_async4(s_w + p * cmax + il, rhs + (size_t)p * ld + il);
          if (carry_in) {
#pragma unroll
            for (int d = 0; d < 6; ++d) cp_async4(s_bw + d * cmax + il, band + (size_t)d * ld + il);
          }
        }
        cp_async_commit();
      }
    }
    // the carry of line k - 1 of this batch row, unless the item before read it
    // (every thread is past that item's band step: s_prev is free)
    const bool fresh = carry_in && (it.k - 1 != have_k || it.b != have_b);
    if (fresh) {
      load_carry(it.k - 1, it.b);
      have_k = it.k - 1;
      have_b = it.b;
      __syncthreads();                   // s_prev holds the carry of line k - 1
    }
    trace_point(q, 2);
    // the stage that item q - 1 used is free (every thread is past its
    // products): it takes item q + kStages - 1, issued once this item's
    // carry is in, so that the copies do not queue before the carry's loads
    if (tid == kStager * 32 && q + kStages - 1 < nitem) stage(q + kStages - 1);

    // w depends on the batch row and the line only: the item before computed it
    const bool same_w = it.k == w_k && it.b == w_b;
    constexpr int kPitch = red_pitch<SPLIT>();
    float* part = red + (q & 1) * V * kPitch;
    if constexpr (kWide) {
      // w of the thread's rows, in place in s_w (note "Wide batches"), then
      // the tensor-core products of 64-row segments (wide_mma.cuh)
      if (!same_w) cp_async_wait_all();  // this thread's rows of w and of the band
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int base = g * kFlowThreads;
        if (base >= cnt) break;
        const int il = base + tid;                        // slice row of this thread
        const int i = i0 + il;                            // its lane / input row
        const bool tile_lane = own_tile && i >= o0 && i < o0 + kLanes;
        if (!same_w && il < cnt) {
          float w[2 * R];
#pragma unroll
          for (int p = 0; p < 2 * R; ++p) w[p] = s_w[p * cmax + il];
          if (carry_in) {
            float accr[R], acci[R];
#pragma unroll
            for (int p = 0; p < R; ++p) accr[p] = acci[p] = 0.f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float br = s_bw[d * cmax + il];
              const float bi = s_bw[(3 + d) * cmax + il];
#pragma unroll
              for (int p = 0; p < R; ++p) {
                const float tr = s_prev[p * pp + il + 7 + d];
                const float ti = s_prev[(R + p) * pp + il + 7 + d];
                accr[p] = accr[p] + br * tr - bi * ti;
                acci[p] = acci[p] + br * ti + bi * tr;
              }
            }
#pragma unroll
            for (int p = 0; p < R; ++p) {
              w[p] = w[p] - accr[p];
              w[R + p] = w[R + p] - acci[p];
            }
          }
#pragma unroll
          for (int p = 0; p < 2 * R; ++p) s_w[p * cmax + il] = w[p];
        }
        if (tile_lane) {
          if (!kBackward) {
#pragma unroll
            for (int p = 0; p < 2 * R; ++p) kept[p * ld + i] = il < cnt ? s_w[p * cmax + il] : 0.f;
          } else if (carry_in) {
            float* x = x_row(it.k - 1, it.b);
#pragma unroll
            for (int p = 0; p < 2 * R; ++p) x[p * ld + i] = s_prev[p * pp + il + 8];
          }
        }
      }
      if (!same_w) __syncthreads();      // a warp's segments hold other threads' rows of w
      wide::line_products<R, S == Storage::kInt8, kFlowWarps>(
          pre, (int)pbytes, sc, s_w, cmax, cnt, i0, part, kPitch, !kNoProducts);
      w_k = it.k;
      w_b = it.b;
      trace_point(q, 3);
    } else {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;

#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int base = g * kFlowThreads;
        if (base >= cnt) break;
        const int il = base + tid;                        // slice row of this thread
        const int i = i0 + il;                            // its lane / input row
        const bool tile_lane = own_tile && i >= o0 && i < o0 + kLanes;
        // the row's plane entries first: they do not wait on the band step
        float cr[kLanes], ci[kLanes];
        if (il < cnt && !kNoProducts) {
          if (S == Storage::kInt8) {
            widen_s8x8(reinterpret_cast<const uint2*>(pre)[il], cr);
            widen_s8x8(reinterpret_cast<const uint2*>(pim)[il], ci);
            const float* sb = sc + (i / kScaleBlock) * 2 * kLanes;
#pragma unroll
            for (int l = 0; l < kLanes; ++l) {
              cr[l] *= sb[l];
              ci[l] *= sb[kLanes + l];
            }
          } else {
            widen_bf16x8(reinterpret_cast<const uint4*>(pre)[il], cr);
            widen_bf16x8(reinterpret_cast<const uint4*>(pim)[il], ci);
          }
        }
        float* w = wk[g];
        if (!same_w) {
#pragma unroll
          for (int p = 0; p < 2 * R; ++p) w[p] = il < cnt ? s_rhs[p * cmax + il] : 0.f;
        }
        if (!same_w && carry_in && il < cnt) {
          float accr[R], acci[R];
#pragma unroll
          for (int p = 0; p < R; ++p) accr[p] = acci[p] = 0.f;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float br = s_band[d * cmax + il];
            const float bi = s_band[(3 + d) * cmax + il];
#pragma unroll
            for (int p = 0; p < R; ++p) {
              const float tr = s_prev[p * pp + il + 7 + d];
              const float ti = s_prev[(R + p) * pp + il + 7 + d];
              accr[p] = accr[p] + br * tr - bi * ti;
              acci[p] = acci[p] + br * ti + bi * tr;
            }
          }
#pragma unroll
          for (int p = 0; p < R; ++p) {
            w[p] = w[p] - accr[p];
            w[R + p] = w[R + p] - acci[p];
          }
        }
        // this row's products, both planes: t_re += wr cr - wi ci, t_im += wi cr + wr ci
        if (il < cnt && !kNoProducts) {
#pragma unroll
          for (int p = 0; p < R; ++p)
#pragma unroll
            for (int l = 0; l < kLanes; ++l) {
              acc[p * kLanes + l] += w[p] * cr[l] - w[R + p] * ci[l];
              acc[(R + p) * kLanes + l] += w[R + p] * cr[l] + w[p] * ci[l];
            }
        }
        if (tile_lane) {
          // the tile's own lanes, by the CTA whose slice holds them (zero on
          // the padding lanes): y (forward) is w; x (backward) of the line
          // before is the carry just read
          if (!kBackward) {
#pragma unroll
            for (int p = 0; p < 2 * R; ++p) kept[p * ld + i] = il < cnt ? w[p] : 0.f;
          } else if (carry_in) {
            float* x = x_row(it.k - 1, it.b);
#pragma unroll
            for (int p = 0; p < 2 * R; ++p) x[p * ld + i] = s_prev[p * pp + il + 8];
          }
        }
      }
      w_k = it.k;
      w_b = it.b;
      trace_point(q, 3);

      // the warps' sums (a warp past the slice holds zeros), added in warp
      // order and published as this half's sums of the tile
      const float sum = warp_transpose_sum<V>(acc);
      if (lane % (32 / V) == 0) part[(lane / (32 / V)) * kPitch + warp] = sum;
    }
    __syncthreads();
    trace_point(q, 4);
    // the last warp, which has the fewest rows, adds the warps' sums and
    // publishes
    if (warp == kPublisher) {
      for (int vi = lane; vi < V; vi += 32) {
        const float4* sums = reinterpret_cast<const float4*>(part + vi * kPitch);
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < kFlowWarps / 4; ++c) {     // in warp order
          const float4 f = sums[c];
          v += f.x;
          v += f.y;
          v += f.z;
          v += f.w;
        }
        const int p = vi / kLanes, o = o0 + vi % kLanes;
        st_word(slot(it.k, it.b) + ((size_t)o * 2 * R + p) * kSplit + rank, v,
                fa.epoch + (unsigned)it.k);
      }
      trace_point(q, 5, kPublisher * 32);
    }
  }
  // the backward pass's last line: x of the tiles' own lanes once both
  // halves' sums are in
  if (kBackward) {
    for (int q = (a.count - 1) * tiles_blk; q < nitem; ++q) {
      const Item it = item(q);
      const int o0 = it.t * kLanes;
      if (o0 < i0 || o0 >= ilim || tid >= kLanes * NW) continue;
      const int i = o0 + tid / NW, h = tid % NW;       // word h of lane i
      const uint2* const ptr[1] = {i < n ? slot(it.k, it.b) + ((size_t)i * NW + h) * 2
                                         : nullptr};
      uint4 v[1];
      poll_words<1, !kNoFlagWait>(ptr, v, fa.epoch + (unsigned)it.k);
      float* x = x_row(it.k, it.b);
      if (kSplit == 2) {
        x[h * ld + i] = __uint_as_float(v[0].x) + __uint_as_float(v[0].z);
      } else {
        x[2 * h * ld + i] = __uint_as_float(v[0].x);
        x[(2 * h + 1) * ld + i] = __uint_as_float(v[0].z);
      }
    }
  }
}

// Launches a flag-handoff pass with SPLIT CTAs a tile: a cooperative launch
// of as many tiles' CTAs as can be co-resident, at most one set per tile
template <int R, bool kBackward, Storage S, int SPLIT>
inline cudaError_t launch_flow_split(const FlowArgs& fa, int sms, cudaStream_t stream) {
  auto kernel = flow_kernel<R, kBackward, S, SPLIT>;
  const size_t smem = flow_smem_bytes<R, S, SPLIT>(fa.a.ld);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  constexpr int threads = flow_threads<SPLIT>();
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int sets_fit = per_sm * sms / SPLIT;
  if (sets_fit < 1) return cudaErrorLaunchOutOfResources;
  const int tiles = fa.a.batch * (fa.a.ld / kLanes);
  const int sets = tiles < sets_fit ? tiles : sets_fit;
  void* params[] = {const_cast<FlowArgs*>(&fa)};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3(SPLIT * sets), dim3(threads), params,
                                     smem, stream);
}

// One CTA a tile where a whole line's stage buffers fit, else two; a line too
// long for two is refused.  (Two CTAs a tile where one fits measured slower
// at n = 801, one batch row and sixteen: PERF.md §6.)
template <int R, bool kBackward, Storage S>
inline cudaError_t launch_flow(const FlowArgs& fa, cudaStream_t stream) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ld = fa.a.ld;
  const bool one_fits = flow_smem_bytes<R, S, 1>(ld) <= (size_t)optin &&
                        slice_rows<1>(ld) <= flow_groups<1>() * flow_threads<1>();
  const bool two_fit = flow_smem_bytes<R, S, 2>(ld) <= (size_t)optin &&
                       slice_rows<2>(ld) <= flow_groups<2>() * flow_threads<2>();
  const int split = THOMAS_SPLIT != 0 ? THOMAS_SPLIT : (one_fits ? 1 : 2);
  if ((split == 1 && !one_fits) || (split == 2 && !two_fit))
    return cudaErrorInvalidValue;                            // line too long
  return split == 1 ? launch_flow_split<R, kBackward, S, 1>(fa, sms, stream)
                    : launch_flow_split<R, kBackward, S, 2>(fa, sms, stream);
}

// A dense pass (bf16, or int8 when scales are given) of r = 1, 2, 4 or 8
// right-hand sides on the flag-handoff step
template <bool kBackward, Storage S>
inline cudaError_t launch_flow_r(int r, const FlowArgs& fa, cudaStream_t stream) {
  switch (r) {
    case 1: return launch_flow<1, kBackward, S>(fa, stream);
    case 2: return launch_flow<2, kBackward, S>(fa, stream);
    case 4: return launch_flow<4, kBackward, S>(fa, stream);
    case 8: return launch_flow<8, kBackward, S>(fa, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBackward>
inline cudaError_t run_flow_pass(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                                 cudaStream_t stream) {
  if (a.batch < 1 || a.m < 1 || a.n < 1 || a.ld < a.n || a.ld % kLanes != 0 ||
      !launch_width(r) || a.count < 1 || a.first < 0 || a.first >= a.m || xchg == nullptr ||
      epoch == 0u || epoch + (unsigned)a.count < epoch)
    return cudaErrorInvalidValue;
  const FlowArgs fa{a, xchg, epoch};
  if (a.scale != nullptr) return launch_flow_r<kBackward, Storage::kInt8>(r, fa, stream);
  return launch_flow_r<kBackward, Storage::kBf16>(r, fa, stream);
}


// ---------------------------------------------------------------------------
// The step driven by a step map: the cached forward pass (dense bf16, int8 and
// banded+tail pivots, thomas_fwd_cached.cu), the backward pass on banded+tail
// pivots (PassMap below, thomas_bwd.cu) and the fused sweep directions
// (sweep_fused.cu).  The same handoff, work split, staging and reduction as
// flow_kernel; a map says, for each tile of each line step, where its
// operands are (FlowTile), and the step computes for the tile's lanes
//
//     w = rhs [+- cpl . (trace - trace_sub)] - band . carry,     t = C^{-1} w.
//
// What the map adds to the dense passes (PERF.md §6 measures each):
//   - Head windows.  A tile's input rows are a window of the line (Cols: i0,
//     cnt) and the CTA takes their part in its slice, one bulk copy per
//     plane; the band and right-hand rows come whole, one copy each (with two
//     CTAs a tile, one copy per row of the item's rows to 16 bytes: fewer
//     copies to issue paid more than fewer bytes).  It waits only on the
//     tiles that publish the carry lanes of its rows (at several tiles a CTA,
//     on those of its slice).
//   - One slot of exchange words per line step for the whole launch, (steps, B,
//     ld, 2r, SPLIT) words: no slot is written twice in a launch, so no CTA
//     can overwrite words another still reads, however far apart narrow
//     windows let CTAs run (the four-line ring of flow_kernel rests on every
//     tile reading every tile), and the words of any earlier step stay
//     readable.  So a sweep's traces are the words of the backward step that
//     produced them: the injection reads them, less a row written before the
//     launch (the reflection correction), as it reads a carry.
//   - A carry handed in (t_init, or the down sweep's t stack): a row written
//     before the launch, read with plain loads, no flag.
//   - Private y lines.  A backward step of a sweep needs y of its rows, which
//     the same CTA formed as w at the forward step of that line: it keeps them
//     in its own lines of `priv` and stages them with the other operands, so
//     it waits on no one for them (its threads fence their stores for the
//     bulk copies, which are issued steps later); the first backward line's y
//     is w of the step just before, still in the threads' registers.
//   - The part of w that no later step makes (the right-hand rows, the
//     injection, whose coupling rows are prefetched into L1 while the trace's
//     words are read) is formed before the carry's wait.
//   - Outputs (the t stack, the volume, the down sweep's u_np) are stored by
//     the publisher from its sums with one CTA a tile; with two, the CTA whose
//     slice holds the tile reads both halves' words back and stores their sum.
//     y of the tile's lanes is stored as w is formed.
// Every wait is on an earlier step, every tile of a step is handled by a
// resident CTA in step order, so nothing waits forever (and a poll traps after
// 2^24 tries).  The dense passes through this body (the trivial map, PassMap
// below, built with -DTHOMAS_MAP_STEP=1) measured up to 16 % slower than
// flow_kernel, which they keep (PERF.md §6); flow_kernel stages the same rows
// (its slice) for every tile, which head windows do not share.

// Ablation bits beside those above: no injection (no trace read, no cpl
// products); no outputs (y, t, traces and private y lines not stored)
constexpr bool kNoInjection = THOMAS_ABLATE & 128;
constexpr bool kNoOutputs = THOMAS_ABLATE & 256;

// One work item of a step map: one tile of one line step
struct FlowTile {
  Cols cols;               // the tile's input rows i0 .. i0 + cnt - 1 and their pivot run
  const float* band;       // (6, ld) band applied to the carry; null: no carry term
  int carry_step;          //   >= 0: the carry is the words of this step
  const float* carry_row;  //   else this (2R, ld) row written before the launch
  const float* rhs;        // (2R, ld) right-hand rows written before the launch; null:
  int rhs_priv;            //   >= 0: the CTA's private y line rhs_priv; else zero
  int keep_priv;           // >= 0: w of the tile's rows kept in that private line
  float* kept;             // (2R, ld): w of the tile's own lanes, or null
  const float* cpl;        // (6, ld) injection band, or null ...
  int trace_step;          //   ... times the words of this step ...
  const float* trace_sub;  //   ... less this row written before the launch (or null)
  float sign;              //   added (+1) or subtracted (-1)
  float* out;              // (2R, ld): t of the tile's lanes, or null
};

__device__ __forceinline__ FlowTile flow_tile() {
  FlowTile ft;
  ft.band = ft.carry_row = ft.rhs = ft.cpl = ft.trace_sub = nullptr;
  ft.kept = ft.out = nullptr;
  ft.carry_step = ft.rhs_priv = ft.keep_priv = ft.trace_step = -1;
  ft.sign = 1.f;
  return ft;
}

// What the tiles of one launch of a step map share
struct FlowLaunch {
  int steps;               // line steps; step k publishes flag epoch + k into slot k
  int batch;               // batch rows; tiles are batch row-major, ld / 8 a row
  int n, ld;
  uint2* xchg;             // (steps, batch, ld, 2r, SPLIT) exchange words, zeroed once
  unsigned epoch;
  float* priv;             // (grid, priv_lines, 2r, slice rows) private y lines, or null
  int priv_lines;
};

// mbarriers, the warps' sums, the carry rows (and the trace rows, kInject),
// then the stage ring
template <int R, Storage S, int SPLIT, bool kInject>
__host__ __device__ constexpr size_t map_smem_bytes(int ld) {
  return 64 + flow_red_bytes<R, SPLIT>() +
         (kInject ? 2 : 1) * flow_prev_bytes<R>(slice_rows<SPLIT>(ld)) +
         flow_w_bytes<R>(slice_rows<SPLIT>(ld)) +
         kStages * flow_stage_bytes<R, S>(slice_rows<SPLIT>(ld), ld);
}

template <int R, Storage S, int SPLIT, bool kInject, class Items>
__device__ __forceinline__ void run_flow(const Items& items, const FlowLaunch& fl) {
  constexpr int kFlowThreads = flow_threads<SPLIT>();
  constexpr int kFlowWarps = kFlowThreads / 32;
  constexpr int V = 2 * R * kLanes;     // output values of a tile: rows x lanes
  constexpr int NW = SPLIT * R;         // 16-byte words a lane: 2R rows x SPLIT halves
  constexpr int kPollBatch = poll_batch<R, SPLIT>();
  constexpr int kGroups = flow_groups<SPLIT>();
  constexpr int kRowBytes = S == Storage::kInt8 ? 8 : 16;    // a tile's pivot row
  // wide batches (note "Wide batches"): w in shared memory, no injection and
  // no private lines (the fused sweeps take r <= 2)
  constexpr bool kWide = wide<R>();
  static_assert(!(kWide && kInject), "the fused sweeps take r = 1 or 2");
  const int n = fl.n, ld = fl.ld;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)blockIdx.x % SPLIT;
  const int pair = (int)blockIdx.x / SPLIT;
  const int npairs = (int)gridDim.x / SPLIT;
  const int T = ld / kLanes;
  const int cmax = slice_rows<SPLIT>(ld);
  const int sbase = rank * cmax;                    // this CTA's slice: rows sbase ..
  const int send = min(sbase + cmax, n);            //   send - 1

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);                 // [kStages]
  float* red = reinterpret_cast<float*>(smem + 64);                     // warps' sums
  float* s_prev = reinterpret_cast<float*>(smem + 64 + flow_red_bytes<R, SPLIT>());
  const int pp = cmax + 16;               // row pitch of s_prev: lane sbase - 8 at 0
  float* s_trace = s_prev + 2 * R * pp;   // kInject: the trace rows, same layout
  // wide batches: w of the slice's rows, [2R][cmax], and the band rows
  // [6][cmax], indexed by row - sbase
  float* s_w = reinterpret_cast<float*>(smem + 64 + flow_red_bytes<R, SPLIT>() +
                                        (kInject ? 2 : 1) * flow_prev_bytes<R>(cmax));
  float* s_bw = s_w + 2 * R * cmax;
  unsigned char* ring = smem + 64 + flow_red_bytes<R, SPLIT>() +
                        (kInject ? 2 : 1) * flow_prev_bytes<R>(cmax) + flow_w_bytes<R>(cmax);
  const size_t stage_bytes = flow_stage_bytes<R, S>(cmax, ld);
  const size_t pbytes = (size_t)cmax * kRowBytes;
  const unsigned nsc = (unsigned)scale_buf_bytes<S>(ld);
  float* priv = fl.priv == nullptr
                    ? nullptr
                    : fl.priv + (size_t)blockIdx.x * fl.priv_lines * 2 * R * cmax;

  // work items: a run of consecutive tiles (batch row-major) of each step
  const int total = fl.batch * T;
  const int tiles_blk = total / npairs + (pair < total % npairs);
  const int tile0 = pair * (total / npairs) + min(pair, total % npairs);
  const int nitem = fl.steps * tiles_blk;

  struct Item {
    int k, b, t, r0, r1;    // step, batch row, tile; its rows in this slice
    FlowTile ft;
  };
  auto item = [&](int q) {
    Item it;
    it.k = q / tiles_blk;
    const int tile = tile0 + (q - it.k * tiles_blk);
    it.b = tile / T;
    it.t = tile - it.b * T;
    it.ft = items.tile(it.k, it.b, it.t);
    it.r0 = max(it.ft.cols.i0, sbase);
    it.r1 = max(min(it.ft.cols.i0 + it.ft.cols.cnt, send), it.r0);
    return it;
  };
  // the exchange words of step k, batch row b (lane-major)
  auto slot = [&](int k, int b) {
    return fl.xchg + ((size_t)k * fl.batch + b) * ld * NW * 2;
  };
  // the words of step k, batch row b, of lanes lo .. hi - 1, both halves
  // added in rank order, less `sub` (a row written before the launch), into
  // dst; polled by all threads together
  auto load_words = [&](int k, int b, int lo, int hi, float* dst, const float* sub) {
    const uint2* src = slot(k, b);
    const unsigned want = fl.epoch + (unsigned)k;
    const int words = (hi - lo) * NW;
    if constexpr (kWide) {          // (no trace rows: sub is null)
      const int nw = kNoCarryLoad ? 0 : words;
      for (int w0 = 0; w0 < nw; w0 += kFlowThreads * kPollBatch) {
        uint4 v[kPollBatch];
        poll_strided<kPollBatch, !kNoFlagWait>(src + (size_t)lo * NW * 2, w0 + tid,
                                                kFlowThreads, nw, v, want);
#pragma unroll
        for (int u = 0; u < kPollBatch; ++u) {
          const int w = w0 + tid + u * kFlowThreads;
          if (w >= nw) continue;
          const int at = lo + w / NW - (sbase - 8), h = w % NW;
          if (SPLIT == 2) {
            dst[h * pp + at] = __uint_as_float(v[u].x) + __uint_as_float(v[u].z);
          } else {
            dst[2 * h * pp + at] = __uint_as_float(v[u].x);
            dst[(2 * h + 1) * pp + at] = __uint_as_float(v[u].z);
          }
        }
      }
    } else {
      for (int w0 = 0; w0 < words; w0 += kFlowThreads * kPollBatch) {
        const uint2* ptr[kPollBatch];
#pragma unroll
        for (int u = 0; u < kPollBatch; ++u) {
          const int w = w0 + tid + u * kFlowThreads;
          ptr[u] = w < words && !kNoCarryLoad ? src + ((size_t)lo * NW + w) * 2 : nullptr;
        }
        uint4 v[kPollBatch];
        poll_words<kPollBatch, !kNoFlagWait>(ptr, v, want);
#pragma unroll
        for (int u = 0; u < kPollBatch; ++u) {
          if (ptr[u] == nullptr) continue;
          const int w = w0 + tid + u * kFlowThreads;
          const int o = lo + w / NW, h = w % NW, at = o - (sbase - 8);
          if (SPLIT == 2) {         // word h: row h, halves 0 and 1
            const float x = __uint_as_float(v[u].x) + __uint_as_float(v[u].z);
            dst[h * pp + at] = sub == nullptr ? x : x - sub[(size_t)h * ld + o];
          } else {                  // words 2h, 2h + 1: rows 2h, 2h + 1
            const float x0 = __uint_as_float(v[u].x), x1 = __uint_as_float(v[u].z);
            dst[2 * h * pp + at] = sub == nullptr ? x0 : x0 - sub[(size_t)2 * h * ld + o];
            dst[(2 * h + 1) * pp + at] = sub == nullptr ? x1 : x1 - sub[(size_t)(2 * h + 1) * ld + o];
          }
        }
      }
    }
  };
  // lanes lo .. hi - 1 of a row written before the launch
  auto load_row = [&](const float* src, int lo, int hi, float* dst) {
    const int cnt = hi - lo;
    for (int i = tid; i < 2 * R * cnt && !kNoCarryLoad; i += kFlowThreads) {
      const int p = i / cnt, o = lo + i - p * cnt;
      dst[p * pp + o - (sbase - 8)] = __ldcg(src + (size_t)p * ld + o);
    }
  };

  // the operands of item q that depend on no step of the launch, into stage
  // q % kStages (one thread); an item of the same step, batch row and rows as
  // the one before shares its w and takes no band or right-hand rows
  int st_k = -1, st_b = -1, st_r0 = -1, st_r1 = -1, st_keep = -1;   // the last staged item's
  auto stage = [&](int q) {
    const Item it = item(q);
    const bool same_rows = it.b == st_b && it.r0 == st_r0 && it.r1 == st_r1;
    const bool new_w = !(it.k == st_k && same_rows);
    // the right-hand rows: the map's, or this CTA's private line, unless that
    // is the line the item before kept (its w is still in the registers)
    const float* rhs = it.ft.rhs;
    size_t rhs_pitch = ld;
    if (rhs == nullptr && it.ft.rhs_priv >= 0 && !kNoOutputs &&
        !(it.ft.rhs_priv == st_keep && same_rows)) {
      rhs = priv + (size_t)it.ft.rhs_priv * 2 * R * cmax - sbase;
      rhs_pitch = cmax;
    }
    if (new_w) st_keep = it.ft.keep_priv;
    st_k = it.k;
    st_b = it.b;
    st_r0 = it.r0;
    st_r1 = it.r1;
    unsigned char* st = ring + (size_t)(q % kStages) * stage_bytes;
    uint64_t* bar = full + q % kStages;
    const int rows = it.r1 - it.r0;
    const unsigned plane_bytes =
        S == Storage::kInt8 ? 8u * ((rows + 1) & ~1) : 16u * rows;
    // band and right-hand rows a0 .. a1 - 1: with one CTA a tile whole rows,
    // back to back at pitch ld, one copy each kind (fewer copies to issue
    // pays more than fewer bytes); else the item's rows to 16 bytes
    const bool whole = cmax == ld;
    const int a0 = whole ? 0 : it.r0 & ~3, a1 = whole ? ld : min((it.r1 + 3) & ~3, ld);
    const unsigned row_bytes = 4u * (a1 - a0);
    const int nrows = new_w && !kNoRowCopies && !kWide      // (wide: copied in by the threads)
                          ? (it.ft.band != nullptr ? 6 : 0) + (rhs != nullptr ? 2 * R : 0)
                          : 0;
    unsigned bytes = nrows * row_bytes;
    if (!kNoPlaneCopies) bytes += 2 * plane_bytes + nsc;
    if (rows == 0) bytes = 0;
    mbar_expect_tx(bar, bytes);
    if (bytes == 0) return;
    if (!kNoPlaneCopies) {
      const size_t off = (size_t)(it.r0 - it.ft.cols.i0) * kRowBytes;
      bulk_copy(st, it.ft.cols.re + off, plane_bytes, bar);
      bulk_copy(st + pbytes, it.ft.cols.im + off, plane_bytes, bar);
      if (S == Storage::kInt8) bulk_copy(st + 2 * pbytes, it.ft.cols.scale, nsc, bar);
    }
    if (nrows == 0) return;
    float* rows_at = reinterpret_cast<float*>(st + 2 * pbytes + nsc) + (a0 - sbase);
    if (it.ft.band != nullptr) {
      if (whole)
        bulk_copy(rows_at, it.ft.band, 6 * row_bytes, bar);
      else
        for (int d = 0; d < 6; ++d)
          bulk_copy(rows_at + d * cmax, it.ft.band + (size_t)d * ld + a0, row_bytes, bar);
    }
    if (rhs != nullptr) {
      if (whole && rhs_pitch == (size_t)ld)
        bulk_copy(rows_at + 6 * cmax, rhs, 2 * R * row_bytes, bar);
      else
        for (int p = 0; p < 2 * R; ++p)
          bulk_copy(rows_at + (6 + p) * cmax, rhs + p * rhs_pitch + a0, row_bytes, bar);
    }
  };
  constexpr int kStager = kFlowWarps - 2, kPublisher = kFlowWarps - 1;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < (kInject ? 2 : 1) * 2 * R * pp; i += kFlowThreads) s_prev[i] = 0.f;
  __syncthreads();
  if (tid == kStager * 32)
    for (int q = 0; q < kStages - 1 && q < nitem; ++q) stage(q);

  long long have_src = -1LL << 62;      // what s_prev holds: source, lanes
  int have_lo = 0, have_hi = 0;
  float wk[kGroups][2 * R];             // w of this thread's rows, of the item key w_*,
  int w_k = -1, w_b = -1, w_r0 = -1, w_r1 = -1, w_keep = -1;   // kept in private line w_keep
  for (int q = 0; q < nitem; ++q) {
    const Item it = item(q);
    const FlowTile& ft = it.ft;
    const int o0 = it.t * kLanes;
    const bool own_tile = o0 >= sbase && o0 < sbase + cmax;   // its lanes lie in the slice
    const int rows = it.r1 - it.r0;
    const bool same_w = it.k == w_k && it.b == w_b && it.r0 == w_r0 && it.r1 == w_r1;
    const bool carry_in = ft.band != nullptr && rows > 0 && !kNoBandStep;
    const bool inject = kInject && ft.cpl != nullptr && rows > 0 && !kNoInjection;
    const unsigned char* st = ring + (size_t)(q % kStages) * stage_bytes;
    const unsigned char* pre = st;
    const unsigned char* pim = st + pbytes;
    const float* sc = reinterpret_cast<const float*>(st + 2 * pbytes);
    const float* s_band = reinterpret_cast<const float*>(st + 2 * pbytes + nsc) - sbase;
    const float* s_rhs = s_band + 6 * cmax;       // both indexed by the row

    mbar_wait(full + q % kStages, (unsigned)(q / kStages) & 1u);
    float* const pv = priv == nullptr ? nullptr : priv - sbase;   // indexed by the row
    // 1. the part of w that waits on no unfinished step, before the carry's
    // wait: the right-hand rows (staged, or the CTA's own private line) and
    // the injection of the words of an earlier step
    const int lo_i = max(it.r0 - 1, 0), hi_i = min(it.r1 + 1, n);
    if (inject && !same_w) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {          // the coupling rows, while the trace is read
        const int i = it.r0 + g * kFlowThreads + tid;
        if (i < it.r1)
          for (int d = 0; d < 6; ++d) prefetch_l1(ft.cpl + (size_t)d * ld + i);
      }
      load_words(ft.trace_step, it.b, lo_i, hi_i, s_trace, ft.trace_sub);
      __syncthreads();                  // s_trace holds the trace lanes of the rows
    }
    // y of the private line the item before kept is w in the registers
    const bool rhs_regs = ft.rhs == nullptr && ft.rhs_priv >= 0 && !kNoOutputs &&
                          ft.rhs_priv == w_keep && it.b == w_b && it.r0 == w_r0 &&
                          it.r1 == w_r1;
    const bool rhs_staged = ft.rhs != nullptr || (ft.rhs_priv >= 0 && !kNoOutputs);
    if constexpr (kWide) {
      // w starts as the right-hand rows (and the band rows): each thread's
      // rows copied into s_w and s_bw while the carry is polled (every warp
      // is past the products of the item before: both are free)
      if (!same_w && !kNoRowCopies) {
        for (int i = it.r0 + tid; i < it.r1; i += kFlowThreads) {
#pragma unroll
          for (int p = 0; p < 2 * R; ++p) {
            if (ft.rhs != nullptr)
              cp_async4(s_w + p * cmax + i - sbase, ft.rhs + (size_t)p * ld + i);
            else
              s_w[p * cmax + i - sbase] = 0.f;
          }
          if (carry_in) {
#pragma unroll
            for (int d = 0; d < 6; ++d)
              cp_async4(s_bw + d * cmax + i - sbase, ft.band + (size_t)d * ld + i);
          }
        }
        cp_async_commit();
      }
    } else {
      if (!same_w) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (g * kFlowThreads >= rows) break;
          const int i = it.r0 + g * kFlowThreads + tid;
          if (i >= it.r1) break;
          float* w = wk[g];
          if (!rhs_regs) {
#pragma unroll
            for (int p = 0; p < 2 * R; ++p) w[p] = rhs_staged ? s_rhs[p * cmax + i] : 0.f;
          }
          if (inject) {          // + sign . (cpl . trace)
            float injr[R], inji[R];
#pragma unroll
            for (int p = 0; p < R; ++p) injr[p] = inji[p] = 0.f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float br = __ldg(ft.cpl + (size_t)d * ld + i);
              const float bi = __ldg(ft.cpl + (size_t)(3 + d) * ld + i);
#pragma unroll
              for (int p = 0; p < R; ++p) {
                const float tr = s_trace[p * pp + i - sbase + 7 + d];
                const float ti = s_trace[(R + p) * pp + i - sbase + 7 + d];
                injr[p] = injr[p] + br * tr - bi * ti;
                inji[p] = inji[p] + br * ti + bi * tr;
              }
            }
#pragma unroll
            for (int p = 0; p < R; ++p) {
              w[p] = w[p] + ft.sign * injr[p];
              w[R + p] = w[R + p] + ft.sign * inji[p];
            }
          }
        }
      }
    }
    // 2. the carry lanes of the item's rows, i0 - 1 .. i0 + cnt within [0, n)
    // (of the whole slice at several tiles a CTA, so that they share it)
    bool loaded = false;
    if (carry_in && !same_w) {
      const int lo = tiles_blk > 1 ? max(sbase - 1, 0) : lo_i;
      const int hi = tiles_blk > 1 ? min(send + 1, n) : hi_i;
      const long long src = ft.carry_step >= 0
                                ? (long long)ft.carry_step * fl.batch + it.b
                                : -1LL - it.b;
      if (src != have_src || lo < have_lo || hi > have_hi) {
        if (ft.carry_step >= 0)
          load_words(ft.carry_step, it.b, lo, hi, s_prev, nullptr);
        else
          load_row(ft.carry_row, lo, hi, s_prev);
        have_src = src;
        have_lo = lo;
        have_hi = hi;
        loaded = true;
      }
    }
    if (loaded) __syncthreads();        // s_prev holds the carry lanes of the rows
    // the stage that item q - 1 used is free (every thread is past its
    // products): it takes item q + kStages - 1, issued once this item's
    // carry is in, so that the copies do not queue before the carry's loads
    if (tid == kStager * 32 && q + kStages - 1 < nitem) stage(q + kStages - 1);

    // 3. w -= band . carry, and the products
    constexpr int kPitch = red_pitch<SPLIT>();
    float* part = red + (q & 1) * V * kPitch;
    float acc[kWide ? 1 : V];           // r <= 2: this thread's partial sums
    if constexpr (kWide) {     // (no private lines: r <= 2 only)
      if (!same_w) cp_async_wait_all();  // this thread's rows of w and of the band
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (g * kFlowThreads >= rows) break;
        const int il = g * kFlowThreads + tid;
        const int i = it.r0 + il;
        if (il >= rows) break;
        float* w = s_w + i - sbase;                   // w[p * cmax]
        if (!same_w && carry_in) {        // - band . carry
          float accr[R], acci[R];
#pragma unroll
          for (int p = 0; p < R; ++p) accr[p] = acci[p] = 0.f;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float br = s_bw[d * cmax + i - sbase];
            const float bi = s_bw[(3 + d) * cmax + i - sbase];
#pragma unroll
            for (int p = 0; p < R; ++p) {
              const float tr = s_prev[p * pp + i - sbase + 7 + d];
              const float ti = s_prev[(R + p) * pp + i - sbase + 7 + d];
              accr[p] = accr[p] + br * tr - bi * ti;
              acci[p] = acci[p] + br * ti + bi * tr;
            }
          }
#pragma unroll
          for (int p = 0; p < R; ++p) {
            w[p * cmax] = w[p * cmax] - accr[p];
            w[(R + p) * cmax] = w[(R + p) * cmax] - acci[p];
          }
        }
        // y (w) of the tile's own lanes, by the CTA whose slice holds them
        if (own_tile && i >= o0 && i < o0 + kLanes && ft.kept != nullptr && !kNoOutputs) {
#pragma unroll
          for (int p = 0; p < 2 * R; ++p) ft.kept[(size_t)p * ld + i] = w[p * cmax];
        }
      }
      if (!same_w) __syncthreads();      // a warp's segments hold other threads' rows of w
      wide::line_products<R, S == Storage::kInt8, kFlowWarps>(
          pre, (int)pbytes, sc, s_w + it.r0 - sbase, cmax, rows, it.r0, part, kPitch,
          !kNoProducts);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;

#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (g * kFlowThreads >= rows) break;
        const int il = g * kFlowThreads + tid;          // the thread's row of the item
        const int i = it.r0 + il;
        const bool live = il < rows;
        float cr[kLanes], ci[kLanes];
        if (live && !kNoProducts) {
          if (S == Storage::kInt8) {
            widen_s8x8(reinterpret_cast<const uint2*>(pre)[il], cr);
            widen_s8x8(reinterpret_cast<const uint2*>(pim)[il], ci);
            const float* sb = sc + (i / kScaleBlock) * 2 * kLanes;
#pragma unroll
            for (int l = 0; l < kLanes; ++l) {
              cr[l] *= sb[l];
              ci[l] *= sb[kLanes + l];
            }
          } else {
            widen_bf16x8(reinterpret_cast<const uint4*>(pre)[il], cr);
            widen_bf16x8(reinterpret_cast<const uint4*>(pim)[il], ci);
          }
        }
        float* w = wk[g];
        if (!same_w && live) {
          if (carry_in) {        // - band . carry
            float accr[R], acci[R];
#pragma unroll
            for (int p = 0; p < R; ++p) accr[p] = acci[p] = 0.f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float br = s_band[d * cmax + i];
              const float bi = s_band[(3 + d) * cmax + i];
#pragma unroll
              for (int p = 0; p < R; ++p) {
                const float tr = s_prev[p * pp + i - sbase + 7 + d];
                const float ti = s_prev[(R + p) * pp + i - sbase + 7 + d];
                accr[p] = accr[p] + br * tr - bi * ti;
                acci[p] = acci[p] + br * ti + bi * tr;
              }
            }
#pragma unroll
            for (int p = 0; p < R; ++p) {
              w[p] = w[p] - accr[p];
              w[R + p] = w[R + p] - acci[p];
            }
          }
          if (ft.keep_priv >= 0 && !kNoOutputs) {
#pragma unroll
            for (int p = 0; p < 2 * R; ++p)
              pv[((size_t)ft.keep_priv * 2 * R + p) * cmax + i] = w[p];
            fence_proxy_async_global();   // for the bulk copy of a backward step
          }
        }
        // this row's products, both planes: t_re += wr cr - wi ci, t_im += wi cr + wr ci
        if (live && !kNoProducts) {
#pragma unroll
          for (int p = 0; p < R; ++p)
#pragma unroll
            for (int l = 0; l < kLanes; ++l) {
              acc[p * kLanes + l] += w[p] * cr[l] - w[R + p] * ci[l];
              acc[(R + p) * kLanes + l] += w[R + p] * cr[l] + w[p] * ci[l];
            }
        }
        // y (w) of the tile's own lanes, by the CTA whose slice holds them
        if (live && own_tile && i >= o0 && i < o0 + kLanes && ft.kept != nullptr && !kNoOutputs) {
#pragma unroll
          for (int p = 0; p < 2 * R; ++p) ft.kept[(size_t)p * ld + i] = w[p];
        }
      }
    }
    // the tile's padding lanes (>= n): w is zero there
    if (ft.kept != nullptr && own_tile && tid < V && o0 + tid % kLanes >= n && !kNoOutputs)
      ft.kept[(size_t)(tid / kLanes) * ld + o0 + tid % kLanes] = 0.f;
    if (!same_w) w_keep = ft.keep_priv;
    w_k = it.k;
    w_b = it.b;
    w_r0 = it.r0;
    w_r1 = it.r1;

    // the warps' sums (a warp past the rows holds zeros), added in warp order
    // and published as this half's sums of the tile (wide batches stored
    // theirs in line_products)
    if constexpr (!kWide) {
      const float sum = warp_transpose_sum<V>(acc);
      if (lane % (32 / V) == 0) part[(lane / (32 / V)) * kPitch + warp] = sum;
    }
    __syncthreads();
    if (warp == kPublisher) {
      for (int vi = lane; vi < V; vi += 32) {
        const int p = vi / kLanes, o = o0 + vi % kLanes;
        const float4* sums = reinterpret_cast<const float4*>(part + vi * kPitch);
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < kFlowWarps / 4; ++c) {     // in warp order
          const float4 f = sums[c];
          v += f.x;
          v += f.y;
          v += f.z;
          v += f.w;
        }
        st_word(slot(it.k, it.b) + ((size_t)o * 2 * R + p) * SPLIT + rank, v,
                fl.epoch + (unsigned)it.k);
        if (SPLIT == 1 && ft.out != nullptr && !kNoOutputs) ft.out[(size_t)p * ld + o] = v;
      }
    }
    // two CTAs a tile: the one whose slice holds it stores both halves' sum
    if (SPLIT == 2 && warp == 0 && own_tile && ft.out != nullptr && !kNoOutputs) {
      for (int vi = lane; vi < V; vi += 32) {
        const int p = vi / kLanes, o = o0 + vi % kLanes;
        const uint2* const ptr[1] = {slot(it.k, it.b) + ((size_t)o * 2 * R + p) * 2};
        uint4 v[1];
        poll_words<1, !kNoFlagWait>(ptr, v, fl.epoch + (unsigned)it.k);
        ft.out[(size_t)p * ld + o] = __uint_as_float(v[0].x) + __uint_as_float(v[0].z);
      }
    }
  }
}

// Launches a step map on the flag-handoff step: kernel1 (one CTA a tile)
// where a slice of a whole line fits one CTA, else kernel2 (two); a line too
// long for two is refused.  A cooperative launch of as many tiles' CTAs as can
// be co-resident, at most one set per tile, so a grid that does not fit is
// refused instead of spinning.
template <int R, Storage S, bool kInject, class Map>
inline cudaError_t launch_map(void (*kernel1)(const Map), void (*kernel2)(const Map),
                              const Map& map, int tiles, cudaStream_t stream) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ld = map.fl.ld;
  const size_t smem1 = map_smem_bytes<R, S, 1, kInject>(ld);
  const size_t smem2 = map_smem_bytes<R, S, 2, kInject>(ld);
  const bool one_fits =
      smem1 <= (size_t)optin && slice_rows<1>(ld) <= flow_groups<1>() * flow_threads<1>();
  const bool two_fit =
      smem2 <= (size_t)optin && slice_rows<2>(ld) <= flow_groups<2>() * flow_threads<2>();
  const int split = THOMAS_SPLIT != 0 ? THOMAS_SPLIT : (one_fits ? 1 : 2);
  if ((split == 1 && !one_fits) || (split == 2 && !two_fit))
    return cudaErrorInvalidValue;                            // line too long
  void (*kernel)(const Map) = split == 1 ? kernel1 : kernel2;
  const size_t smem = split == 1 ? smem1 : smem2;
  const int threads = split == 1 ? flow_threads<1>() : flow_threads<2>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int sets_fit = per_sm * sms / split;
  if (sets_fit < 1) return cudaErrorLaunchOutOfResources;
  const int sets = tiles < sets_fit ? tiles : sets_fit;
  Map args = map;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3(split * sets), dim3(threads), params,
                                     smem, stream);
}

// A whole pass as a step map (the trivial one): step k is line first +- k of
// every batch row, its carry the words of step k - 1.  It is the backward
// pass on banded+tail pivots (kBanded: head windows on lines < tail_start,
// thomas_bwd.cu); a build with -DTHOMAS_MAP_STEP=1
// (benchmarks_torch/thomas_probe.py) also launches the dense forward and
// backward passes so, to time the shared body against flow_kernel.
template <int R, bool kBackward, Storage S, bool kBanded>
struct PassMap {
  PassArgs a;
  FlowLaunch fl;

  __device__ __forceinline__ FlowTile tile(int k, int b, int t) const {
    const int j = kBackward ? a.first - k : a.first + k;
    const int s = __ldg(a.s_idx + b);
    const size_t row = (size_t)2 * R * a.ld;
    FlowTile ft = flow_tile();
    if constexpr (S == Storage::kInt8)
      ft.cols = tile_cols_int8(a.cre, a.cim, a.scale, s, j, t, a.m, a.n, a.ld);
    else
      ft.cols = tile_cols(a.cre, a.cim, a.hre, a.him, s, j, t, a.m, a.n, a.ld,
                          kBanded ? a.tail_start : 0, kBanded ? a.half : 0);
    if (k > 0) {
      ft.band = a.band + ((size_t)s * a.m + j) * 6 * a.ld;
      ft.carry_step = k - 1;
    }
    ft.rhs = a.rhs + ((size_t)b * a.m + j) * row;
    if (kBackward)           // x stack holds lines first - count + 1 .. first
      ft.out = a.out + ((size_t)b * a.count + (j - (a.first - a.count + 1))) * row;
    else
      ft.kept = a.kept + ((size_t)b * a.m + j) * row;
    return ft;
  }
};

template <int R, bool kBackward, Storage S, bool kBanded, int SPLIT>
__global__ void __launch_bounds__(flow_threads<SPLIT>(), 512 / flow_threads<SPLIT>())
    pass_map_kernel(const PassMap<R, kBackward, S, kBanded> items) {
  run_flow<R, S, SPLIT, false>(items, items.fl);
}

template <int R, bool kBackward, Storage S, bool kBanded>
inline cudaError_t launch_pass_map(const PassArgs& a, uint2* xchg, unsigned epoch,
                                   cudaStream_t stream) {
  using Map = PassMap<R, kBackward, S, kBanded>;
  const Map map{a, FlowLaunch{a.count, a.batch, a.n, a.ld, xchg, epoch, nullptr, 0}};
  return launch_map<R, S, false, Map>(pass_map_kernel<R, kBackward, S, kBanded, 1>,
                                      pass_map_kernel<R, kBackward, S, kBanded, 2>, map,
                                      a.batch * (a.ld / kLanes), stream);
}

// A pass through run_flow: on banded+tail pivots (kBanded: bf16, 0 <
// tail_start < m, half >= 0, no scales), else on dense planes (bf16, or int8
// when scales are given).  The exchange needs one slot per line (count slots)
template <bool kBackward, Storage S>
inline cudaError_t launch_pass_map_r(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                                     cudaStream_t stream) {
  switch (r) {
    case 1: return launch_pass_map<1, kBackward, S, false>(a, xchg, epoch, stream);
    case 2: return launch_pass_map<2, kBackward, S, false>(a, xchg, epoch, stream);
    case 4: return launch_pass_map<4, kBackward, S, false>(a, xchg, epoch, stream);
    case 8: return launch_pass_map<8, kBackward, S, false>(a, xchg, epoch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBackward, bool kBanded = false>
inline cudaError_t run_map_pass(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                                cudaStream_t stream) {
  if (a.batch < 1 || a.m < 1 || a.n < 1 || a.ld < a.n || a.ld % kLanes != 0 ||
      !launch_width(r) || a.count < 1 || a.first < 0 || a.first >= a.m || xchg == nullptr ||
      epoch == 0u || epoch + (unsigned)a.count < epoch)
    return cudaErrorInvalidValue;
  if constexpr (kBanded) {
    if (r > kMaxRhsBanded || a.tail_start < 1 || a.tail_start >= a.m || a.half < 0 ||
        a.scale != nullptr)
      return cudaErrorInvalidValue;
    return r == 1 ? launch_pass_map<1, kBackward, Storage::kBf16, true>(a, xchg, epoch, stream)
                  : launch_pass_map<2, kBackward, Storage::kBf16, true>(a, xchg, epoch, stream);
  } else {
    if (a.scale != nullptr) return launch_pass_map_r<kBackward, Storage::kInt8>(r, a, xchg, epoch, stream);
    return launch_pass_map_r<kBackward, Storage::kBf16>(r, a, xchg, epoch, stream);
  }
}

}  // namespace thomas
