// Flag-handoff line step: the body of the two dense substitution passes
//
//     flow_kernel<R, false, S>      forward pass     thomas_fwd.cu
//     flow_kernel<R, true,  S>      backward pass    thomas_bwd.cu
//
// on bf16 or int8 pivot planes (S).  The cached forward pass, the passes on
// banded+tail pivots and the fused sweeps keep the grid-barrier step of
// thomas_line.cuh, whose note describes the layouts, the numerics contract
// and the bound; this step computes the same function on the same layouts:
//
//     w = rhs_j - band_j . prev,     t = C_j^{-1} w,
//
// bf16 or int8 planes widened to f32, f32 carries, bands and sums.
//
// Why a new step.  A line of the grid-barrier step at n = 801 takes 4.5 us
// against 0.78 us of bytes (PERF.md §5): it ends in a grid barrier (a fence,
// an atomic and a spin through L2), only then do all blocks issue a second L2
// round trip for the whole carry, and each block recomputes the band step for
// all n lanes and reduces all n input rows with 128 threads.  Here a line
// waits on latency, so the step is built to shorten the chain from one
// line's last product to the next line's first (PERF.md §6 measures each
// point):
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
// Limits.  r = 1 or 2 (the wrappers run wider batches as groups), and a
// slice whose kStages stage buffers fit in one CTA's shared memory and whose
// rows fit flow_groups rows a thread: one CTA a tile up to n = 976 in bf16 at
// r = 2, two up to n = 1968 in bf16 and 2448 in int8 (measured by
// test_longest_line_fits).  Anything else is refused with
// cudaErrorInvalidValue before a launch, and a cooperative launch that does
// not fit returns its error.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "thomas_line.cuh"

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

// Ablation of the flag-handoff step (benchmarks_torch/thomas_ablation.py),
// bits of THOMAS_ABLATE beside those of the grid-barrier step: a line without
// the flag wait (the words are read once, flags unchecked); the bits of the
// grid-barrier step leave out the carry's load, the band step, the products
// and the bulk copies of the planes or of the band and right-hand rows.
// Results are wrong; only the time is read.
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

// One stage buffer of a slice of cmax rows: the two plane runs (16 B a row in
// bf16, 8 B in int8), the int8 scales of the tile, the 6 band rows and the 2R
// right-hand rows of the slice
template <int R, Storage S>
__host__ __device__ constexpr size_t flow_stage_bytes(int cmax, int ld) {
  return (size_t)2 * cmax * (S == Storage::kInt8 ? 8 : 16) + scale_buf_bytes<S>(ld) +
         sizeof(float) * (size_t)(6 + 2 * R) * cmax;
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

template <int R, Storage S, int SPLIT>
__host__ __device__ constexpr size_t flow_smem_bytes(int ld) {
  return 64 + flow_red_bytes<R, SPLIT>() + flow_prev_bytes<R>(slice_rows<SPLIT>(ld)) +
         kStages * flow_stage_bytes<R, S>(slice_rows<SPLIT>(ld), ld);
}

// --- the pass -----------------------------------------------------------------

constexpr int kSlots = 4;              // lines of the exchange ring

struct FlowArgs {
  PassArgs a;              // operands as for pass_kernel (dense layout)
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
  // 16-byte words a thread polls at once: all of its words at n = 801
  constexpr int kPollBatch = (kSplit == 1 ? 2 : 4) * R;
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
  unsigned char* ring = smem + 64 + flow_red_bytes<R, SPLIT>() + flow_prev_bytes<R>(cmax);
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
  };

  // the operands of item q that do not depend on the carry, into stage q %
  // kStages (one thread)
  auto stage = [&](int q) {
    const Item it = item(q);
    // an item of the same batch row and line as the one before uses its w:
    // no band or right-hand rows
    const bool new_w = !kNoRowCopies && (q == 0 || item(q - 1).k != it.k || item(q - 1).b != it.b);
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

    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    // w depends on the batch row and the line only: the item before computed it
    const bool same_w = it.k == w_k && it.b == w_b;

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

    // the warps' sums (a warp past the slice holds zeros), added in warp order
    // and published as this half's sums of the tile
    const float sum = warp_transpose_sum<V>(acc);
    constexpr int kPitch = red_pitch<SPLIT>();
    float* part = red + (q & 1) * V * kPitch;
    if (lane % (32 / V) == 0) part[(lane / (32 / V)) * kPitch + warp] = sum;
    __syncthreads();
    trace_point(q, 4);
    // the last warp, which has the fewest rows, adds the warps' sums and
    // publishes
    if (warp == kPublisher && lane < V) {
      const float4* sums = reinterpret_cast<const float4*>(part + lane * kPitch);
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < kFlowWarps / 4; ++c) {     // in warp order
        const float4 f = sums[c];
        v += f.x;
        v += f.y;
        v += f.z;
        v += f.w;
      }
      const int p = lane / kLanes, o = o0 + lane % kLanes;
      st_word(slot(it.k, it.b) + ((size_t)o * 2 * R + p) * kSplit + rank, v,
              fa.epoch + (unsigned)it.k);
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

// A dense pass (bf16, or int8 when scales are given) on the flag-handoff step
template <bool kBackward>
inline cudaError_t run_flow_pass(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                                 cudaStream_t stream) {
  if (a.batch < 1 || a.m < 1 || a.n < 1 || a.ld < a.n || a.ld % kLanes != 0 || r < 1 ||
      r > kMaxRhs || a.count < 1 || a.first < 0 || a.first >= a.m || xchg == nullptr ||
      epoch == 0u || epoch + (unsigned)a.count < epoch)
    return cudaErrorInvalidValue;
  const FlowArgs fa{a, xchg, epoch};
  if (a.scale != nullptr)
    return r == 1 ? launch_flow<1, kBackward, Storage::kInt8>(fa, stream)
                  : launch_flow<2, kBackward, Storage::kInt8>(fa, stream);
  return r == 1 ? launch_flow<1, kBackward, Storage::kBf16>(fa, stream)
                : launch_flow<2, kBackward, Storage::kBf16>(fa, stream);
}

}  // namespace thomas
