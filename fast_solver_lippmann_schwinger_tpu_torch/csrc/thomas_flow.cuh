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
// Wide batches.  A launch takes r = 1, 2, 4, 8 or 16 right-hand sides, on
// dense planes and on banded+tail pivots, in the passes and in the fused
// sweeps (the wrappers pad r = 3 to 4, r = 5..7 to 8 and r = 9..15 to 16 with
// zero columns, and run more than 16 as groups of 16), so that each pivot
// plane or head window is read once for the whole batch, as the TPU kernels
// do for any r (pallas_thomas.py,
// _solve_cached_multi, _fwd_ht / _bwd_ht; pallas_sweep.py, _sweep_fused).
// r = 1 and 2 keep the step above.  Wider, a thread's 2r x 8 partial sums
// would not fit its registers, so the products run on tensor cores, and the
// step is built around them (run_wide, below; every line kernel shares it,
// head windows and the sweeps as the next part says).  A first version kept
// the step above otherwise: at n = 801 and r = 8 a line took 7.2 us,
// of it 2.2 in the carry's words (every CTA read the whole line's 2r x 810
// flagged words, 104 KB, about 10.5 MB of L2 a line), 1.2 in the band step
// (every one of the 101 CTAs formed w for all 801 lanes) and 1.9 in the
// products (w split again for every 64-row segment, B fragments an entry at a
// time; thomas_ablation.py --r 8, PERF.md §5).  The wide step:
//   - Pre-added rows.  The CTA that finishes a tile of line k also forms its
//     part of line k + 1's w, w = rhs - band . t, from the tile's 8 lanes: the
//     full value on the lanes whose three taps lie in the tile, and on the two
//     edge lanes (8t - 1 and 8t + 8) the one tap it holds, as an edge term.
//     The band step runs once a lane, not once a CTA, off the consumers'
//     chain: a consumer adds the edge terms to the rows, nothing else.  With
//     two CTAs a tile, the one that does not hold the tile's lanes hands its
//     partial sums over (X rows behind a flag of their own) and the other adds
//     them in rank order and publishes the tile alone.
//   - Plain rows behind flags.  The rows go to a rows buffer as plain f32
//     (half the bytes of flagged words), then one flag word a tile (a
//     release: the publishing warp's stores, __syncwarp, a fence and the
//     flag; one CTA a tile flags its tiles of a line and batch row together
//     after the last).  Flags lie in the exchange words 32 bytes apart, rows
//     in a buffer of their own (thomas_kernels.Exchange), so no stale row is
//     ever read as a flag.
//   - One copy of the rows a CTA.  One warp polls the flags of the tiles its
//     slice needs (acquire loads), and one thread bulk-copies the slice's 2r
//     rows into shared memory and its tiles' edge terms into the stage buffer
//     that the item before used (cp.async.bulk, after a proxy fence); once
//     they are in, each warp adds the edge terms to its k-steps' columns and
//     splits their w (16 input rows, the first aligned to 16: a slice of two
//     CTAs a tile may start 8 rows into one, and an int8 k-step then lies in
//     one scale block) once into three bf16 terms (wide_mma.cuh), kept in
//     shared memory as fragments for every tile of the line and batch row
//     that the CTA takes.  Lanes of the CTA's own tiles write y (w).  (Every
//     thread adding the edge terms into the copied rows met the same banks
//     eight at a time; the loads of a warp's own k-steps straight from
//     global memory, eight cache lines a load, cost more than the copy.)
//   - The products of wide_mma.cuh's plane section: B fragments by one
//     ldmatrix.x4.trans (bf16) or a byte permute (int8) from the staged
//     plane run, each k-step on fresh sums, int8 k-steps scaled by their
//     block before they are added, at r = 4 the h and m terms stacked in M
//     (two products a part, not three).
//   - Two stage buffers (plane runs and int8 scales only), one item ahead: w
//     of the slice takes the shared memory of a third.
//   - Outputs (the cached pass's t stack, the backward pass's x stack) by the
//     publisher of the CTA that holds the tile's lanes.
// By ablation (thomas_ablation.py --r 4,8, PERF.md §6) a first form of this
// step, where every warp polled the flags of its own k-steps and loaded
// their rows straight from global memory, lost most of its line there; the
// same rows as flagged words (flags beside the values, no fence) lost more.
// No atomics: a pass is bit-identical from
// run to run.  The four-slot ring of the dense passes holds as before (every
// CTA reads every tile of its slice, and publishes line k only after it read
// line k - 1).
//
// Wide batches on banded+tail pivots.  The cached forward pass, the backward
// pass and the two fused sweep directions run the same wide step at r = 4, 8
// (run_wide, driven by their step maps); what head windows and the sweeps add:
//   - Head windows meet the k-steps.  A tile's window, input rows 8t - half ..
//     8t + 7 + half within [0, n), starts 4 or 12 rows past a 16-row boundary
//     at half = 100 (by the parity of t), while the k-steps of w stay aligned
//     to 16 rows of the line, so that one split of w serves every tile of the
//     CTA.  The stager copies the window's rows in the CTA's slice to their
//     own rows' places in the stage buffer (ldmatrix takes a row address per
//     lane, so the offset costs nothing), a tile's products take only the
//     k-steps its window meets, and the B fragments' rows outside the window
//     are masked to zero bits after the ldmatrix (the rest of the buffer
//     holds other runs, whose bits may be anything): no k-step reads past
//     the run into the sums.
//   - The rows copy is cut to the windows.  A CTA copies and splits only the
//     k-steps of the union of its tiles' windows (of a step and batch row;
//     208 of 808 rows at half = 100 with one tile a CTA, about 300 with 13),
//     with the edge terms of their tiles; dense tail lines take the whole
//     slice.  It still waits on the flags of every tile of its slice, so
//     that every CTA publishes step k only after every tile published step
//     k - 1: the four-slot ring of the dense passes then holds as it is (a
//     narrower wait would let CTAs at the two ends of a line drift apart by
//     up to T / window steps, and the ring would have to grow with it).
//   - Where the traces live.  The narrow step's traces are the words of the
//     backward step that made them; the wide step hands over pre-added w,
//     not t, so no such words exist.  A CTA holds the same tiles for the
//     whole launch (batch 1, the same run of tiles at every step), so the
//     publisher of a tile stores the tile's lanes of a trace as an output row
//     at the step that makes it (u_np and u_n in the down sweep, u_0 and u_1
//     as lines of the up sweep's volume), and at the step before an injected
//     line the same thread reads them back and adds the coupling band's taps
//     to the rows and the edge terms, as it adds the band's taps on t:
//     program order of one thread orders the store before the load, however
//     many steps lie between.  A step without a carry step (the first line
//     of a slab's phase) forms its w itself, the injection from the trace
//     row's lanes that other CTAs stored (loads at GPU scope); it waits on
//     the flags of the step before like any other step, and every trace was
//     stored before its publisher's release of a flag of that step or an
//     earlier one (acquire, then a barrier of the CTA, then the loads).
//   - y of a backward line is w of that line's forward step, which the CTA
//     formed for its slice: it keeps it in its private lines of the sweep's
//     scratch (private_floats), and reads back its tiles' lanes (the
//     publisher, for the next step's rows) or its slice (a step without a
//     carry step), plain loads of its own stores behind barriers of the CTA.
//   - The rows buffer is a ring.  A step's rows are read only by the next
//     step, and every step waits on the step before, so the sweeps take the
//     dense passes' four slots of rows (64 r ld bytes a slot, 1.66 MB at r = 8,
//     ld = 808) and of flag words, not one a step (1472 slots a launch at the
//     801^2 headline, 609 MB of rows at r = 8); the backward pass on
//     banded+tail pivots too.  The private y lines stay as the narrow step
//     has them (101 x 22 x 16 x 816 floats, 116 MB at r = 8), and the up
//     sweep reads the down sweep's y stack.
//
// Sixteen right-hand sides.  Every line kernel takes r = 16 on the same wide
// step, so that two launches of eight, each paying the step's latencies
// (the flag wait, the rows' copy, the publisher's chain), become one.  The
// 32 stacked rows are two m16 tiles of the r = 8 layout, right-hand sides
// 0-7 and 8-15 (wide_mma.cuh), multiplied by one load of each B fragment
// (ldmatrix or the int8 byte permute).  Parked A fragments would double to
// 156 KB at n = 801 (three bf16 terms of 32 rows a k-step) and push a
// block past the card's shared memory with one CTA a tile, and to 80 KB with
// two, one block an SM: a grid of 66 sets for 101 tiles.  So at r = 16 no
// fragment is parked: prep finishes w in place (edge terms added, columns
// outside the slice zeroed, y and the private lines written) and each warp
// splits its k-steps' w into the three terms again for each tile it
// multiplies, one m16 tile at a time (on the main path a CTA takes one tile
// of a line, so nothing is split twice; at 16 batch rows a CTA's tiles of a
// line split their w once each).  A block then holds the warps' sums of 256
// values, the publisher's operands (34 floats a lane: four tile lanes of a
// right-hand side), w of the slice and two stage buffers, 206,144 bytes at
// n = 801 with one CTA a tile: the r = 8 grid of 101 CTAs.  A stage buffer
// is at least the edge terms that the rows' copy stages in it (32 rows of
// two floats a tile, more than the int8 runs).  Each k-step's products run
// on fresh sums in f32, three bf16 terms, as at r = 8.  Two things keep the
// step within 128 registers a thread without spills (without them it
// spills up to 308 bytes and an r = 16 pass takes up to 28 % longer;
// PERF.md §6): the publisher parks its 34 next-step operands in shared
// memory as soon as they are loaded (their loads overlap the flag wait)
// instead of keeping them in registers over prep, and each of the poller's
// 32 lanes issues the bulk copies of one of the 32 rows (after lane 0's
// expect_tx) instead of one thread issuing all of them.
//
// Limits.  r = 1, 2, 4, 8 or 16 on either layout and in the fused sweeps, and
// a slice whose stage buffers fit in one CTA's shared memory and whose rows
// fit flow_groups rows a thread: one CTA a tile up to n = 976 in bf16 at
// r = 2, two up to n = 1968 in bf16 and 2448 in int8, the cached forward pass
// and the backward pass on banded+tail pivots (step maps without the trace
// rows) too; the fused sweeps at r <= 2, which keep the trace rows beside the
// carry, 912 and 1840; the wide step (w of the slice, its A fragments and the
// plane runs; the fused sweeps add no shared memory to it) at r = 8 one CTA
// a tile up to n = 912 in bf16 and 1064 in int8, two up to 1904 in bf16 and
// 2192 in int8, at r = 4 up to 1352 and 1536 on one, 2560 on two, at r = 16
// (no parked fragments) up to 952 on one and 2032 on two in either storage
// (test_longest_line_fits; the Python mirror is thomas_kernels.line_fits).
// Anything else is refused with cudaErrorInvalidValue before a launch, and a
// cooperative launch that does not fit returns its error.
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
// read once, flags unchecked); the wide step (r = 4, 8, 16) reads the bits as
// its own phases: no band step (the producer's), no rows copy (neither
// flags nor the copy of w's rows and edge terms), no flag wait, no
// producer's loads of the next line's band and right-hand rows (the row
// copies' bit), plus the releases' fences and the edge terms (below).  Its
// results are wrong and only its time is read; the package always builds
// with 0.
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

// the cp.async copies issued so far as one group (plane_pass.cuh's y staging)
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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

// Wide batches (r = 4, 8, 16; notes above)
template <int R>
__host__ __device__ constexpr bool wide() {
  return R > 2;
}

// One stage buffer of a slice of cmax rows: the two plane runs (16 B a row in
// bf16, 8 B in int8), the int8 scales of the tile, the 6 band rows and the 2R
// right-hand rows of the slice (r <= 2; the wide step's stages: wide_smem_bytes)
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

// The wide step (r = 4, 8, 16; note "Wide batches"): the k-steps (16 input
// rows) of a slice of cmax rows, its first k-step aligned to 16 rows (a slice
// may start 8 rows into one); the 16-byte groups of a lane's A fragments of a
// k-step kept in shared memory (three bf16 terms at r = 8, two at r = 4; none
// at r = 16, whose warps split w again for each tile: note "Sixteen right-hand
// sides"); the rows a stage buffer holds of each plane part (the slice from
// its 16-row boundary to the end of its last k-step)
__host__ __device__ constexpr int wide_ksteps(int cmax) { return (cmax + 23) / 16; }
template <int R>
__host__ __device__ constexpr int wide_groups() { return R == 16 ? 0 : R == 8 ? 3 : 2; }
__host__ __device__ constexpr int wide_stage_rows(int cmax) { return cmax + 24; }
// stage buffers of the wide step: one item ahead (w of the slice takes the
// shared memory of a third)
constexpr int kWideStages = 2;
// the row pitch of w of a slice in shared memory, in floats: 8 more than a
// multiple of 32, so that a half-warp's fragment loads meet no bank twice
__host__ __device__ constexpr int wide_spitch(int cmax) {
  return (16 * wide_ksteps(cmax) + 31) / 32 * 32 + 8;
}
// the publisher's next-step operands, parked during an item: 2R + 2 floats
// a lane of one warp (rows and band taps of R / 4 tile lanes, an edge band),
// kept at 20 for r <= 8
template <int R>
__host__ __device__ constexpr int wide_pub_floats() { return R == 16 ? 34 : 20; }
template <int R>
__host__ __device__ constexpr size_t wide_pub_bytes() {
  return sizeof(float) * 32 * wide_pub_floats<R>();
}
// One stage buffer of the wide step: the two plane runs and the scales; at
// r = 16 at least the edge terms that the rows' copy stages in it ([2R][e_n]
// [2] floats, e_n at most Tp with one CTA a tile, cmax / 8 + 4 with two),
// which at r <= 8 always fit
template <int R, Storage S, int SPLIT>
__host__ __device__ constexpr size_t wide_stage_bytes(int ld) {
  const size_t runs = (size_t)2 * wide_stage_rows(slice_rows<SPLIT>(ld)) *
                          (S == Storage::kInt8 ? 8 : 16) +
                      scale_buf_bytes<S>(ld);
  const int T = ld / kLanes;
  const size_t edges = (size_t)8 * 2 * R *
                       (SPLIT == 1 ? T + (T & 1) : slice_rows<SPLIT>(ld) / kLanes + 4);
  return R == 16 && edges > runs ? edges : runs;
}

// mbarriers (64 B), the warps' sums, the publisher's operands, w of the
// slice (2R rows at wide_spitch), the A fragments of the slice's k-steps (a
// lane's groups side by side: [k-step][group][lane] x 16 B; none at r = 16),
// then the stage ring (plane runs and scales only)
template <int R, Storage S, int SPLIT>
__host__ __device__ constexpr size_t wide_smem_bytes(int ld) {
  return 64 + flow_red_bytes<R, SPLIT>() + wide_pub_bytes<R>() +
         sizeof(float) * 2 * R * (size_t)wide_spitch(slice_rows<SPLIT>(ld)) +
         (size_t)wide_ksteps(slice_rows<SPLIT>(ld)) * wide_groups<R>() * 32 * 16 +
         kWideStages * wide_stage_bytes<R, S, SPLIT>(ld);
}

template <int R, Storage S, int SPLIT>
__host__ __device__ constexpr size_t flow_smem_bytes(int ld) {
  return wide<R>() ? wide_smem_bytes<R, S, SPLIT>(ld)
                   : 64 + flow_red_bytes<R, SPLIT>() + flow_prev_bytes<R>(slice_rows<SPLIT>(ld)) +
                         kStages * flow_stage_bytes<R, S>(slice_rows<SPLIT>(ld), ld);
}

// 16-byte exchange words a thread polls at once: all of its words at n = 801
template <int R, int SPLIT>
__host__ __device__ constexpr int poll_batch() {
  return (SPLIT == 1 ? 2 : 4) * R;
}

// --- the pass -----------------------------------------------------------------

constexpr int kSlots = 4;              // lines of the exchange ring

struct FlowArgs {
  PassArgs a;              // operands (dense layout)
  uint2* xchg;             // (kSlots, B, ld, 2r, SPLIT) exchange words (value, flag);
                           //   the wide step: its flags, as FlowLaunch::rows says
  unsigned epoch;          // flag of the pass's first line step
};

// the wide step of a dense pass (r = 4, 8, 16), below
template <int R, bool kBackward, Storage S, int SPLIT>
__device__ __forceinline__ void flow_wide(const FlowArgs& fa);

// The dense pass at r = 1, 2
template <int R, bool kBackward, Storage S, int SPLIT>
__device__ __forceinline__ void flow_narrow(const FlowArgs& fa) {
  constexpr int kSplit = SPLIT;         // CTAs a tile
  constexpr int kFlowThreads = flow_threads<SPLIT>();
  constexpr int kFlowWarps = kFlowThreads / 32;
  constexpr int V = 2 * R * kLanes;     // output values of a tile: rows x lanes
  constexpr int NW = kSplit * R;        // 16-byte words a lane: 2R rows x kSplit halves
  constexpr int kPollBatch = poll_batch<R, SPLIT>();
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
    const bool new_w = !kNoRowCopies &&
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

template <int R, bool kBackward, Storage S, int SPLIT>
__global__ void __launch_bounds__(flow_threads<SPLIT>(), 512 / flow_threads<SPLIT>())
    flow_kernel(const FlowArgs fa) {
  if constexpr (wide<R>())
    flow_wide<R, kBackward, S, SPLIT>(fa);
  else
    flow_narrow<R, kBackward, S, SPLIT>(fa);
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

// A dense pass (bf16, or int8 when scales are given) of r = 1, 2, 4, 8 or 16
// right-hand sides on the flag-handoff step
template <bool kBackward, Storage S>
inline cudaError_t launch_flow_r(int r, const FlowArgs& fa, cudaStream_t stream) {
  switch (r) {
    case 1: return launch_flow<1, kBackward, S>(fa, stream);
    case 2: return launch_flow<2, kBackward, S>(fa, stream);
    case 4: return launch_flow<4, kBackward, S>(fa, stream);
    case 8: return launch_flow<8, kBackward, S>(fa, stream);
    case 16: return launch_flow<16, kBackward, S>(fa, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBackward>
inline cudaError_t run_flow_pass(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                                 cudaStream_t stream) {
  if (a.batch < 1 || a.m < 1 || a.n < 1 || a.ld < a.n || a.ld % kLanes != 0 ||
      !launch_width(r) || a.count < 1 || a.first < 0 || a.first >= a.m || xchg == nullptr ||
      epoch == 0u || epoch + (unsigned)a.count < epoch || (r > 2 && a.rows == nullptr))
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
//   - One slot of exchange words per line step for the whole launch at r <= 2
//     (the wide step: note "Wide batches on banded+tail pivots"), (steps, B,
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
constexpr bool kNoFences = THOMAS_ABLATE & 512;     // the wide step's releases
constexpr bool kNoEdges = THOMAS_ABLATE & 1024;     // the wide step's edge terms

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
  int trace_step;          //   ... times the words of this step (r <= 2) ...
  const float* trace_row;  //   ... or this (2R, ld) row, an out row of that step (r >= 4) ...
  const float* trace_sub;  //   ... less this row written before the launch (or null)
  float sign;              //   added (+1) or subtracted (-1)
  float* out;              // (2R, ld): t of the tile's lanes, or null
};

__device__ __forceinline__ FlowTile flow_tile() {
  FlowTile ft;
  ft.cols = Cols{nullptr, nullptr, nullptr, 0, 0};
  ft.band = ft.carry_row = ft.rhs = ft.cpl = ft.trace_row = ft.trace_sub = nullptr;
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
  int slots;               // the wide step: slot k % slots holds step k (0: one a step)
  float* rows;             // the wide step's rows (slots x batch x wide_slot_bytes), its
                           //   flags in xchg, (slots, batch, 2, ld / 8, kFlagStride) words
};

// mbarriers, the warps' sums, the carry rows (and the trace rows, kInject),
// then the stage ring
// then the stage ring; the wide step's layout: wide_smem_bytes
template <int R, Storage S, int SPLIT, bool kInject>
__host__ __device__ constexpr size_t map_smem_bytes(int ld) {
  return wide<R>() ? wide_smem_bytes<R, S, SPLIT>(ld)
                   : 64 + flow_red_bytes<R, SPLIT>() +
                         (kInject ? 2 : 1) * flow_prev_bytes<R>(slice_rows<SPLIT>(ld)) +
                         kStages * flow_stage_bytes<R, S>(slice_rows<SPLIT>(ld), ld);
}

// A step map at r = 1, 2
template <int R, Storage S, int SPLIT, bool kInject, class Items>
__device__ __forceinline__ void run_narrow(const Items& items, const FlowLaunch& fl) {
  constexpr int kFlowThreads = flow_threads<SPLIT>();
  constexpr int kFlowWarps = kFlowThreads / 32;
  constexpr int V = 2 * R * kLanes;     // output values of a tile: rows x lanes
  constexpr int NW = SPLIT * R;         // 16-byte words a lane: 2R rows x SPLIT halves
  constexpr int kPollBatch = poll_batch<R, SPLIT>();
  constexpr int kGroups = flow_groups<SPLIT>();
  constexpr int kRowBytes = S == Storage::kInt8 ? 8 : 16;    // a tile's pivot row
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
  unsigned char* ring = smem + 64 + flow_red_bytes<R, SPLIT>() +
                        (kInject ? 2 : 1) * flow_prev_bytes<R>(cmax);
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
    const int nrows = new_w && !kNoRowCopies
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
    float acc[V];                       // this thread's partial sums
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
    // the tile's padding lanes (>= n): w is zero there
    if (ft.kept != nullptr && own_tile && tid < V && o0 + tid % kLanes >= n && !kNoOutputs)
      ft.kept[(size_t)(tid / kLanes) * ld + o0 + tid % kLanes] = 0.f;
    if (!same_w) w_keep = ft.keep_priv;
    w_k = it.k;
    w_b = it.b;
    w_r0 = it.r0;
    w_r1 = it.r1;

    // the warps' sums (a warp past the rows holds zeros), added in warp order
    // and published as this half's sums of the tile
    const float sum = warp_transpose_sum<V>(acc);
    if (lane % (32 / V) == 0) part[(lane / (32 / V)) * kPitch + warp] = sum;
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
  static constexpr bool kWindows = kBanded;      // head windows (run_wide)
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

// ---------------------------------------------------------------------------
// The wide step (r = 4, 8, 16): notes "Wide batches" and "Wide batches on
// banded+tail pivots" at the top of this file.  The dense passes
// (flow_kernel, through PassMap), the cached forward pass (cached_kernel,
// CachedItems), the backward pass on banded+tail pivots (PassMap) and the
// fused sweeps (DownItems, UpItems; kInject) run it; a map's step k takes its
// carry from step k - 1 (or from the row carry_row, or none); a map whose
// kWindows is set has head windows.
// ---------------------------------------------------------------------------

// Bytes of one slot (line step, batch row) of the wide step's rows buffer
// (thomas_kernels.Exchange.wide_rows: 64 R ld)
__host__ __device__ constexpr size_t wide_slot_bytes(int r, int ld) {
  return (size_t)64 * r * ld;
}

// Flag words a slot and batch row takes in the exchange words: the P flags
// of the T tiles, then their X flags, kFlagStride words (32 bytes) apart, so
// that no two tiles' flags share a sector of L2
constexpr int kFlagStride = 4;


// A slot of the rows buffer, in f32 cells: the rows of the next step's w of
// each tile's lanes, P[2R][ld]; its two edge terms, E[2R][Tp][2] (Tp = T
// rounded up to even; side 0: tile t's term of lane 8t - 1, side 1: of lane
// 8t + 8); with two CTAs a tile, X[2R][ld], the partial sums of the CTA that
// does not hold the tile's lanes
template <int R>
struct WideSlot {
  float* base;
  int ld, Tp;
  __device__ __forceinline__ float* p(int row, int col) const {
    return base + (size_t)row * ld + col;
  }
  __device__ __forceinline__ float* e(int row, int tile) const {
    return base + (size_t)2 * R * ld + ((size_t)row * Tp + tile) * 2;
  }
  __device__ __forceinline__ float* x(int row, int col) const {
    return base + (size_t)2 * R * ld + (size_t)4 * R * Tp + (size_t)row * ld + col;
  }
};

// an f32 load at GPU scope (past the incoherent L1), issued once its flag has
// been seen
__device__ __forceinline__ float ld_rows1(const void* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// the flag half of an exchange word, by an acquire load
__device__ __forceinline__ unsigned ld_flag(const uint2* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(reinterpret_cast<const unsigned*>(p) + 1)
               : "memory");
  return v;
}

// The release of a publication: the stores this warp made, ordered before it
// by __syncwarp, then the flag
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// waits until the flag halves of the words at ptr[u] (nullptr: none), polled
// by this lane, all carry `want`; a wait longer than any step takes traps
template <int K>
__device__ __forceinline__ void wait_flag_words(const uint2* const (&ptr)[K], unsigned want) {
  bool ready[K];
#pragma unroll
  for (int u = 0; u < K; ++u) ready[u] = ptr[u] == nullptr;
  for (unsigned polls = 0;; ++polls) {
    unsigned got[K];
#pragma unroll
    for (int u = 0; u < K; ++u) got[u] = ready[u] ? want : ld_flag(ptr[u]);
    bool all = true;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      ready[u] = got[u] == want;
      all = all && ready[u];
    }
    if (all) return;
    if (polls > (1u << 24)) __trap();
  }
}

// all threads of the CTA but the barrier of __syncthreads (barrier 1)
template <int kThreads>
__device__ __forceinline__ void bar_sync1() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

template <int R, Storage S, int SPLIT, bool kInject, class Items>
__device__ __forceinline__ void run_wide(const Items& items, const FlowLaunch& fl) {
  static_assert(R == 4 || R == 8 || R == 16, "the wide step: r = 4, 8 or 16");
  constexpr bool kWindows = Items::kWindows;    // head windows: each tile its own input rows
  constexpr int kThreads = flow_threads<SPLIT>();
  constexpr int kWarps = kThreads / 32;
  constexpr int V = 2 * R * kLanes;             // output values of a tile
  constexpr int NG = wide_groups<R>();          // 16-byte fragment groups a lane and k-step
  constexpr int NQ = R == 4 ? 2 : 4;            // f32 pairs of a lane's A fragments (of a
                                                //   tile of 16 rows at r = 16)
  constexpr int kRowBytes = S == Storage::kInt8 ? 8 : 16;
  constexpr int kPitch = red_pitch<SPLIT>();
  constexpr int kPoller = kWarps - 3, kStager = kWarps - 2, kPublisher = kWarps - 1;
  constexpr int kRedWarps = V / 32;             // the warps that add the warps' sums
  constexpr int LPR = 32 / R;                   // publisher lanes a right-hand side
  constexpr int TL = kLanes / LPR;              // tile lanes a publisher lane
  static_assert((kWarps & (kWarps - 1)) == 0, "k-step i belongs to warp i % kWarps");
  const int n = fl.n, ld = fl.ld, T = ld / kLanes, Tp = T + (T & 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int rank = (int)blockIdx.x % SPLIT;
  const int pair = (int)blockIdx.x / SPLIT;
  const int npairs = (int)gridDim.x / SPLIT;

  // this CTA's slice: input rows i0 .. iend - 1 (lanes i0 .. ilim - 1 are its
  // tiles'), staged from row sb0 (a multiple of 16) as sr plane rows; its
  // k-steps ku0 .. ku0 + nks - 1 of 16 rows (int8: each in one scale block);
  // the tiles whose rows and edge terms w of its rows takes, tlo .. thi
  const int cmax = slice_rows<SPLIT>(ld);
  const int i0 = rank * cmax;
  const int ilim = min(i0 + cmax, ld);
  const int iend = max(min(ilim, n), i0);
  const int sb0 = i0 & ~15;
  const int sr = iend > i0 ? ((iend + 7) & ~7) - sb0 : 0;
  const int ku0 = sb0 / 16;
  const int nks = iend > i0 ? (iend + 15) / 16 - ku0 : 0;
  const int tlo = max((i0 - 1) >> 3, 0), thi = min(iend >> 3, T - 1);
  // the edge terms staged: tiles etlo .. etlo + ece - 1 of each row (an even
  // run from an even tile: 16-byte copies; with one CTA a tile whole rows)
  const int etlo = SPLIT == 1 ? 0 : tlo & ~1;
  const int ece = SPLIT == 1 ? Tp : (thi - etlo + 2) & ~1;
  const int slots = fl.slots > 0 ? fl.slots : fl.steps;
  // k-step i of the slice (ku0 + i of the line) is warp i % kWarps's: the
  // first of a run of k-steps from a that this warp takes
  auto first_kstep = [&](int a) { return a + ((warp - a) & (kWarps - 1)); };

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);               // [kWideStages]
  uint64_t* sbar = full + kWideStages;                                // the w rows' copies
  float* red = reinterpret_cast<float*>(smem + 64);                   // warps' sums
  float* pub = red + flow_red_bytes<R, SPLIT>() / sizeof(float);      // [kPubFloats][32]
  float* stg = pub + wide_pub_bytes<R>() / sizeof(float);             // [2R][spitch]: w
  const int spitch = wide_spitch(cmax);
  uint4* frags = reinterpret_cast<uint4*>(stg + (size_t)2 * R * spitch);
  unsigned char* ring = reinterpret_cast<unsigned char*>(frags) +
                        (size_t)wide_ksteps(cmax) * NG * 32 * 16;
  const size_t pbytes = (size_t)wide_stage_rows(cmax) * kRowBytes;
  const unsigned nsc = (unsigned)scale_buf_bytes<S>(ld);
  const size_t stage_bytes = wide_stage_bytes<R, S, SPLIT>(ld);
  // the sweeps' private y lines of this CTA: line L, stacked row rr, column
  // c at priv[(L 2R + rr) cmax + c - i0] (columns of the slice)
  float* const priv = kInject && fl.priv != nullptr
                          ? fl.priv + (size_t)blockIdx.x * fl.priv_lines * 2 * R * cmax
                          : nullptr;

  // work items: a run of consecutive tiles (batch row-major) of each step
  const int total = fl.batch * T;
  const int tiles_blk = total / npairs + (pair < total % npairs);
  const int tile0 = pair * (total / npairs) + min(pair, total % npairs);
  const int nitem = fl.steps * tiles_blk;
  auto where = [&](int q, int& k, int& b, int& t) {
    k = q / tiles_blk;
    const int tile = tile0 + (q - k * tiles_blk);
    b = tile / T;
    t = tile - b * T;
  };
  // the rows of step k, batch row b; their flags (P: tile t, X: T + t)
  auto slot = [&](int k, int b) {
    WideSlot<R> sl;
    sl.base = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(fl.rows) +
                                       ((size_t)(k % slots) * fl.batch + b) *
                                           wide_slot_bytes(R, ld));
    sl.ld = ld;
    sl.Tp = Tp;
    return sl;
  };
  auto flag_word = [&](int k, int b, int f) {
    return fl.xchg + (((size_t)(k % slots) * fl.batch + b) * 2 * T + f) * kFlagStride;
  };
  // the input rows of a tile's columns that its products take, lo .. hi - 1:
  // the staged run on dense planes; a head window's rows in the slice
  auto window = [&](const Cols& cols, int& lo, int& hi) {
    lo = sb0;
    hi = sb0 + sr;
    if constexpr (Items::kWindows) {
      lo = max(cols.i0, i0);
      hi = max(min(cols.i0 + cols.cnt, iend), lo);
    }
  };

  // the plane runs (and scales) of item q's slice (a head window's rows in
  // it), into stage q % kWideStages at their rows' places (one thread)
  auto stage = [&](int q) {
    int k, b, t;
    where(q, k, b, t);
    const Cols cols = items.tile(k, b, t).cols;
    int lo, hi;
    window(cols, lo, hi);
    unsigned char* st = ring + (size_t)(q % kWideStages) * stage_bytes;
    uint64_t* bar = full + q % kWideStages;
    const unsigned pb = (unsigned)(hi - lo) * kRowBytes;
    const unsigned bytes = pb > 0 && !kNoPlaneCopies ? 2 * pb + nsc : 0u;
    mbar_expect_tx(bar, bytes);
    if (bytes == 0) return;
    const size_t off = (size_t)(lo - cols.i0) * kRowBytes;
    unsigned char* dst = st + (size_t)(lo - sb0) * kRowBytes;
    bulk_copy(dst, cols.re + off, pb, bar);
    bulk_copy(dst + pbytes, cols.im + off, pb, bar);
    if (S == Storage::kInt8) bulk_copy(st + 2 * pbytes, cols.scale, nsc, bar);
  };

  // w of a step k and batch row b (ft: its first item) in stg, row rr at stg
  // + rr spitch, column c at c - sb0, on the k-steps kc0 .. kc1 - 1 of the
  // slice that the CTA's tiles ta .. tb - 1 multiply (all of them on dense
  // planes, the union of the tiles' windows on head windows): the
  // producers' rows, bulk-copied once one warp has seen their flags, with
  // the edge terms of their tiles (copied beside them).  A step without a
  // carry step (the first of a pass, or of a sweep's phase) forms w itself:
  // the right-hand rows (or the CTA's private y line) less band . carry_row,
  // plus the injection; it too waits on the flags of step k - 1, so that
  // every step of a launch waits on the one before (the ring of slots rests
  // on that), and a trace row written at an earlier step is visible.  Then
  // each warp adds the edge terms to its own k-steps and splits them into
  // frags; y (w) of the lanes of the CTA's tiles into ft.kept, w of the
  // slice into the private line ft.keep_priv.
  unsigned sphase = 0;                  // parity of the rows' copies
  auto prep = [&](int q, int k, int b, const FlowTile& ft, int ta, int tb) {
    const bool from_step = ft.carry_step >= 0;
    int kc0 = 0, kc1 = nks, e_lo = etlo, e_n = ece;
    if constexpr (Items::kWindows) {
      // windows grow with the tile and each holds its tile's lanes, so the
      // union is one run: from the first tile's window to the last one's,
      // in the slice (empty where the tiles' windows lie past it)
      const Cols ca = items.tile(k, b, ta).cols, cb = items.tile(k, b, tb - 1).cols;
      const int lo = max(ca.i0, i0), hi = min(cb.i0 + cb.cnt, iend);
      const bool any = hi > lo;
      kc0 = any ? lo / 16 - ku0 : 0;
      kc1 = any ? (hi + 15) / 16 - ku0 : 0;
      // the tiles of the k-steps' lanes and their neighbours
      const int e0 = max(2 * (ku0 + kc0) - 1, tlo), e1 = min(2 * (ku0 + kc1), thi);
      e_lo = e0 & ~1;
      e_n = any && e1 >= e0 ? (e1 - e_lo + 2) & ~1 : 0;
    }
    const int c0 = sb0 + 16 * kc0, ncols = 16 * (kc1 - kc0);
    // the edge terms, [2R][e_n][2] floats, in the stage buffer that item q - 1
    // used (refilled for item q + 1 once every warp has split its w)
    const float* estg = reinterpret_cast<const float*>(
        ring + (size_t)((q + 1) % kWideStages) * stage_bytes);
    const bool edges = from_step && ncols > 0 && e_n > 0 && !kNoCarryLoad && !kNoEdges;
    if (k > 0 && !kNoCarryLoad) {
      const int ks = from_step ? ft.carry_step : k - 1;
      const unsigned want = fl.epoch + (unsigned)ks;
      const WideSlot<R> sl = slot(ks, b);
      if (warp == kPoller) {
        constexpr int kPer = 4;
        for (int u0 = tlo; u0 <= thi; u0 += 32 * kPer) {
          const uint2* ptr[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int tile = u0 + lane + 32 * u;
            ptr[u] = tile <= thi && !kNoFlagWait ? flag_word(ks, b, tile) : nullptr;
          }
          wait_flag_words<kPer>(ptr, want);
        }
        __syncwarp();
        // one lane issues the copies; at r = 16 each lane those of one of
        // the 32 rows, after lane 0's expect_tx
        constexpr int kRowsALane = R == 16 ? 1 : 2 * R;
        if (from_step && (R == 16 || lane == 0)) {
          // the rows the acquires made visible, for the async proxy's copies:
          // the k-steps' w rows (each CTA starting at its own row) and the
          // edge terms of their tiles
          fence_proxy_async_global();
          const unsigned bytes = 4u * ncols;
          const unsigned ebytes = 8u * e_n;
          if (lane == 0)
            mbar_expect_tx(sbar, ncols > 0 ? 2 * R * bytes + (edges ? 2 * R * ebytes : 0u) : 0u);
          if constexpr (R == 16) __syncwarp();
          const int first_row = R == 16 ? lane : 0;
          if (ncols > 0) {
            for (int i = first_row; i < first_row + kRowsALane; ++i) {
              const int rr = (i + (int)blockIdx.x) % (2 * R);
              bulk_copy(stg + rr * spitch + (c0 - sb0), sl.p(rr, c0), bytes, sbar);
            }
          }
          if (edges) {
            float* ed = const_cast<float*>(estg);
            if (SPLIT == 1 && e_lo == 0 && e_n == Tp) {
              if (lane == 0) bulk_copy(ed, sl.e(0, 0), 2 * R * ebytes, sbar);
            } else {
              for (int rr = first_row; rr < first_row + kRowsALane; ++rr)
                bulk_copy(ed + rr * e_n * 2, sl.e(rr, e_lo), ebytes, sbar);
            }
          }
        }
      }
      if (from_step) {
        mbar_wait(sbar, sphase);        // (the poller arrives on it with the bytes)
        sphase ^= 1u;
      } else {
        __syncthreads();                // the flags of step k - 1 are seen
      }
    }
    if (!from_step) {
      for (int e = tid; e < 2 * R * ncols; e += kThreads) {
        const int rr = e / ncols, c = c0 + (e - rr * ncols);
        const int p = rr % R;
        float w = 0.f;
        if (c >= i0 && c < iend) {
          if (ft.rhs != nullptr)
            w = __ldg(ft.rhs + (size_t)rr * ld + c);
          else if (kInject && priv != nullptr && ft.rhs_priv >= 0 && !kNoOutputs)
            w = priv[((size_t)ft.rhs_priv * 2 * R + rr) * cmax + c - i0];
          if (ft.band != nullptr && ft.carry_row != nullptr && !kNoBandStep) {
            float acc = 0.f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const int src = c + d - 1;
              if (src < 0 || src >= n) continue;
              const float br = __ldg(ft.band + (size_t)d * ld + c);
              const float bi = __ldg(ft.band + (size_t)(3 + d) * ld + c);
              const float tr = __ldg(ft.carry_row + (size_t)p * ld + src);
              const float ti = __ldg(ft.carry_row + (size_t)(R + p) * ld + src);
              acc = rr < R ? acc + br * tr - bi * ti : acc + br * ti + bi * tr;
            }
            w -= acc;
          }
          // + sign . cpl . (trace - trace_sub): the trace row was stored at
          // an earlier step by the tiles' publishers (loads at GPU scope)
          if (kInject && ft.cpl != nullptr && !kNoInjection) {
            float acc = 0.f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const int src = c + d - 1;
              if (src < 0 || src >= n) continue;
              const float br = __ldg(ft.cpl + (size_t)d * ld + c);
              const float bi = __ldg(ft.cpl + (size_t)(3 + d) * ld + c);
              float tr = ld_rows1(ft.trace_row + (size_t)p * ld + src);
              float ti = ld_rows1(ft.trace_row + (size_t)(R + p) * ld + src);
              if (ft.trace_sub != nullptr) {
                tr -= __ldg(ft.trace_sub + (size_t)p * ld + src);
                ti -= __ldg(ft.trace_sub + (size_t)(R + p) * ld + src);
              }
              acc = rr < R ? acc + br * tr - bi * ti : acc + br * ti + bi * tr;
            }
            w += ft.sign * acc;
          }
        }
        stg[rr * spitch + (c - sb0)] = w;
      }
    }
    __syncthreads();                    // w is in stg
    // columns c, c + 1 of stacked row rr of w: with the neighbouring tiles'
    // edge terms, zero outside the slice; y (w) of the lanes of the CTA's
    // tiles into ft.kept, w of the slice into the private line ft.keep_priv
    auto w_pair = [&](int rr, int c) {
      float2 w = *reinterpret_cast<const float2*>(stg + rr * spitch + c - sb0);
      const bool nx = c >= i0 && c < iend, ny = nx && c + 1 < iend;
      // the neighbouring tile's edge term: E+ of the tile before a tile's
      // first lane (t = 0), E- of the tile after its last (t = 3)
      if (edges && t4 == 0 && nx && c >= kLanes)
        w.x += estg[(rr * e_n + (c >> 3) - 1 - e_lo) * 2 + 1];
      if (edges && t4 == 3 && ny && (c >> 3) + 1 < T)
        w.y += estg[(rr * e_n + (c >> 3) + 1 - e_lo) * 2];
      const float2 v = make_float2(nx ? w.x : 0.f, ny ? w.y : 0.f);
      if (ft.kept != nullptr && !kNoOutputs && c >= i0 && c < ilim && (c >> 3) >= ta &&
          (c >> 3) < tb) {
        ft.kept[(size_t)rr * ld + c] = v.x;
        ft.kept[(size_t)rr * ld + c + 1] = v.y;
      }
      if (kInject && priv != nullptr && ft.keep_priv >= 0 && !kNoOutputs && nx) {
        float* pr = priv + ((size_t)ft.keep_priv * 2 * R + rr) * cmax + c - i0;
        pr[0] = v.x;
        if (ny) pr[1] = v.y;
      }
      return v;
    };
#pragma unroll 2
    for (int i = first_kstep(kc0); i < kc1; i += kWarps) {
      const int kb = 16 * (ku0 + i);
      if constexpr (R == 16) {
        // w stays in stg, finished in place: the products split it for each
        // tile (pair q of the lane: m16 tile q >> 2, where the products read it)
#pragma unroll
        for (int q = 0; q < 2 * NQ; ++q) {
          const int rr = (q & 1 ? R : 0) + 8 * (q >> 2) + g;
          const int c = kb + 2 * t4 + 8 * ((q >> 1) & 1);
          *reinterpret_cast<float2*>(stg + rr * spitch + c - sb0) = w_pair(rr, c);
        }
      } else {
        float2 vq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) vq[q] = make_float2(0.f, 0.f);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int rr = R == 8 && (q & 1) ? 8 + g : g;
          const int c = kb + 2 * t4 + 8 * (R == 8 ? q >> 1 : q);
          vq[q] = w_pair(rr, c);
        }
        unsigned a[3][4];
        wide::a_frags_of<R>(vq, a);
        uint4* fr = frags + (size_t)i * NG * 32 + lane;
#pragma unroll
        for (int grp = 0; grp < NG; ++grp)
          fr[grp * 32] = make_uint4(a[grp][0], a[grp][1], a[grp][2], a[grp][3]);
      }
    }
    if (edges) bar_sync1<kThreads>();   // every warp is past the edge terms' buffer
  };

  // The publisher's operands of an item's next step: its right-hand side pp
  // and tile lanes li0 .. li0 + TL - 1, their right-hand rows and band rows,
  // and the band of the edge lane it serves (o0 - 1 or o0 + 8); zero where
  // the item has no next step.  Loaded at the item's start, parked in pub
  // once the warp's own w is in (at r = 16 at once; pub[f * 32 + lane]: f =
  // c TL + i rhs, 2 TL + (c 3 + d) TL + i band, 8 TL + c edge band), read
  // after the products.
  const int pp = lane / LPR, li0 = (lane % LPR) * TL;
  constexpr int kPub = 8 * TL + 2;
  static_assert(kPub <= wide_pub_floats<R>(), "the publisher's operands fit pub");

  if (tid == 0) {
    for (int i = 0; i <= kWideStages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == kStager * 32)
    for (int q = 0; q < kWideStages - 1 && q < nitem; ++q) stage(q);

  int w_k = -1, w_b = -1;               // the step and batch row whose w frags holds
  for (int q = 0; q < nitem; ++q) {
    int k, b, t;
    where(q, k, b, t);
    const FlowTile ft = items.tile(k, b, t);
    const int o0 = t * kLanes;
    const bool has_next = k + 1 < fl.steps;
    const int ta = max(tile0, b * T) - b * T;      // the CTA's tiles of this step and row
    const int tb = min(tile0 + tiles_blk, (b + 1) * T) - b * T;
    trace_point(q, 0);
    float pv[kPub];                     // the publisher's operands, in flight
#pragma unroll
    for (int f = 0; f < kPub; ++f) pv[f] = 0.f;
    if (warp == kPublisher && has_next && !kNoRowCopies) {
      const FlowTile nx = items.tile(k + 1, b, t);
      // a next step without a carry step forms its w itself (prep)
      if (!kInject || nx.carry_step >= 0) {
        // its right-hand rows: the map's, or this CTA's private y line (its
        // own w of an earlier step, plain loads)
        const float* nrhs = nx.rhs;
        size_t npitch = ld;
        bool own_line = false;
        if (kInject && nrhs == nullptr && nx.rhs_priv >= 0 && priv != nullptr && !kNoOutputs) {
          nrhs = priv + (size_t)nx.rhs_priv * 2 * R * cmax - i0;
          npitch = cmax;
          own_line = true;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int i = 0; i < TL; ++i) {
            const int o = o0 + li0 + i;
            if (nrhs != nullptr && (!own_line || o < iend)) {
              const float* at = nrhs + (size_t)(c * R + pp) * npitch + o;
              pv[c * TL + i] = own_line ? *at : __ldg(at);
            }
            if (nx.band != nullptr)
#pragma unroll
              for (int d = 0; d < 3; ++d)
                pv[2 * TL + (c * 3 + d) * TL + i] = __ldg(nx.band + (size_t)(c * 3 + d) * ld + o);
          }
          if (nx.band != nullptr && li0 == 0 && o0 >= 1)
            pv[8 * TL + c] = __ldg(nx.band + (size_t)(c * 3 + 2) * ld + o0 - 1);
          if (nx.band != nullptr && li0 + TL == kLanes && o0 + kLanes < ld)
            pv[8 * TL + c] = __ldg(nx.band + (size_t)(c * 3) * ld + o0 + kLanes);
        }
      }
    }
    // r = 16: parked at once, so that no operand stays in flight over prep
    // (34 registers a lane); its loads overlap the flag wait
    constexpr bool kParkEarly = R == 16;
    auto park = [&] {
      if (warp == kPublisher) {
#pragma unroll
        for (int f = 0; f < kPub; ++f) pub[f * 32 + lane] = pv[f];
      }
    };
    if (kParkEarly) park();
    mbar_wait(full + q % kWideStages, (unsigned)(q / kWideStages) & 1u);
    trace_point(q, 1);
    // w of the item's step and batch row, unless the item before had them
    if (k != w_k || b != w_b) {
      prep(q, k, b, ft, ta, tb);
      w_k = k;
      w_b = b;
    }
    trace_point(q, 2);
    // the stage that item q - 1 used is free (every warp is past its
    // products and the edge terms prep staged in it): it takes item q + 1
    if (tid == kStager * 32 && q + 1 < nitem) stage(q + 1);
    if (!kParkEarly) park();

    // the products of this warp's k-steps, each on fresh sums (wide_mma.cuh):
    // on a head window those of its rows, the rows outside it masked
    int wlo, whi;
    window(ft.cols, wlo, whi);
    const int ka = kWindows ? (whi > wlo ? wlo / 16 - ku0 : 0) : 0;
    const int kz = kWindows ? (whi > wlo ? (whi + 15) / 16 - ku0 : 0) : nks;
    const unsigned char* st = ring + (size_t)(q % kWideStages) * stage_bytes;
    // the B fragments of k-step i from the staged run
    auto b_frags = [&](int i, unsigned (&bf)[4]) {
      const int k0 = 16 * (ku0 + i) - sb0;        // the k-step's first staged row
      if constexpr (S == Storage::kBf16) {
        wide::ldsm_b_bf16(st, (int)pbytes, k0, lane, bf);
        if constexpr (kWindows) {
          // rows k0 + 2 t4 (+1) in bf[0] and bf[2], 8 rows on in bf[1] and
          // bf[3], low half first: only the window's rows count (the rest
          // of the stage buffer holds other runs)
          const int row = sb0 + k0 + 2 * t4;
          auto half_mask = [&](int r0) {
            return (r0 >= wlo && r0 < whi ? 0x0000ffffu : 0u) |
                   (r0 + 1 >= wlo && r0 + 1 < whi ? 0xffff0000u : 0u);
          };
          const unsigned m0 = half_mask(row), m1 = half_mask(row + 8);
          bf[0] &= m0;
          bf[2] &= m0;
          bf[1] &= m1;
          bf[3] &= m1;
        } else if (k0 + 8 >= sr) {
          bf[1] = bf[3] = 0u;                       // rows past the staged ones
        }
      } else {
        wide::lds_b_int8(st, (int)pbytes, k0, g, t4, bf);
      }
    };
    // a k-step's products added to the running sums (int8: scaled by the
    // k-step's block)
    auto add_sums = [&](int i, const float (&e1)[4], const float (&e2)[4], float (&z1)[4],
                        float (&z2)[4]) {
      if constexpr (S == Storage::kInt8) {
        // the scales of the k-step's block, output lanes 2t, 2t + 1
        const float* sb = reinterpret_cast<const float*>(st + 2 * pbytes) +
                          (16 * (ku0 + i)) / kScaleBlock * 2 * kLanes;
        const float2 sre = *reinterpret_cast<const float2*>(sb + 2 * t4);
        const float2 sim = *reinterpret_cast<const float2*>(sb + kLanes + 2 * t4);
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          z1[qq] = fmaf(qq & 1 ? sre.y : sre.x, e1[qq], z1[qq]);
          z2[qq] = fmaf(qq & 1 ? sim.y : sim.x, e2[qq], z2[qq]);
        }
      } else {
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          z1[qq] += e1[qq];
          z2[qq] += e2[qq];
        }
      }
    };
    float* part = red + (q & 1) * V * kPitch;
    if constexpr (R == 16) {
      // two m16 tiles of the stacked rows (right-hand sides 0-7 and 8-15),
      // each as at r = 8, on one load of the B fragments; w split here, for
      // this tile (note "Sixteen right-hand sides")
      float z1[2][4] = {}, z2[2][4] = {};
      for (int i = first_kstep(ka); i < kz && !kNoProducts; i += kWarps) {
        const int kb = 16 * (ku0 + i) - sb0;
        unsigned bf[4];
        b_frags(i, bf);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 v[4];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            v[qq] = *reinterpret_cast<const float2*>(
                stg + ((qq & 1 ? R : 0) + 8 * h + g) * spitch + kb + 2 * t4 + 8 * (qq >> 1));
          unsigned a[3][4];
          wide::a_frags_of<8>(v, a);
          float e1[4], e2[4];
          wide::plane_kstep<8>(a, bf, e1, e2);
          add_sums(i, e1, e2, z1[h], z2[h]);
        }
      }
      trace_point(q, 3);
      wide::plane_store_part16(z1, z2, part + warp, kPitch);
    } else {
      float z1[4] = {0.f, 0.f, 0.f, 0.f}, z2[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = first_kstep(ka); i < kz && !kNoProducts; i += kWarps) {
        unsigned a[3][4];
        const uint4* fr = frags + (size_t)i * NG * 32 + lane;
#pragma unroll
        for (int grp = 0; grp < NG; ++grp) {
          const uint4 u = fr[grp * 32];
          a[grp][0] = u.x;
          a[grp][1] = u.y;
          a[grp][2] = u.z;
          a[grp][3] = u.w;
        }
        unsigned bf[4];
        b_frags(i, bf);
        float e1[4], e2[4];
        wide::plane_kstep<R>(a, bf, e1, e2);
        add_sums(i, e1, e2, z1, z2);
      }
      trace_point(q, 3);
      wide::plane_store_part<R>(z1, z2, part + warp, kPitch);
    }
    __syncthreads();
    trace_point(q, 4);
    // the tile's sums, value v by thread v of the last V / 32 warps, in warp
    // order, into the pad of its row of part (part[v * kPitch + kWarps])
    if (warp >= kWarps - kRedWarps) {
      const int v = tid - (kWarps - kRedWarps) * 32;
      const float4* sums = reinterpret_cast<const float4*>(part + v * kPitch);
      float sum = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < kWarps / 4; ++c4) {
        const float4 f4 = sums[c4];
        sum += f4.x;
        sum += f4.y;
        sum += f4.z;
        sum += f4.w;
      }
      part[v * kPitch + kWarps] = sum;
      asm volatile("bar.sync 2, %0;\n" ::"n"(kRedWarps * 32) : "memory");
    }

    // the publisher: the tile's sums in warp order; with two CTAs a tile, the
    // one that does not hold the tile's lanes hands its partial sums over,
    // the other adds them (rank order); the outputs; the next step's rows of
    // the tile's lanes (w less the band's taps inside the tile, plus the
    // injection's) and its two edge terms; the flags
    if (warp == kPublisher) {
      float tv[2][TL];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < TL; ++i) tv[c][i] = part[((c * R + pp) * kLanes + li0 + i) * kPitch + kWarps];
      const WideSlot<R> so = slot(k, b);
      const unsigned flag = fl.epoch + (unsigned)k;
      const bool own = o0 >= i0 && o0 < ilim;       // the tile's lanes lie in this slice
      const bool needed = has_next || (ft.out != nullptr && !kNoOutputs);
      if (SPLIT == 2 && needed) {
        if (!own) {
#pragma unroll
          for (int i = 0; i < TL; ++i) {
            *so.x(pp, o0 + li0 + i) = tv[0][i];
            *so.x(R + pp, o0 + li0 + i) = tv[1][i];
          }
          __syncwarp();
          if (!kNoFences) fence_acq_rel_gpu();
          if (lane == 0) st_word(flag_word(k, b, T + t), 0.f, flag);
        } else {
          const uint2* const ptr[1] = {lane == 0 && !kNoFlagWait ? flag_word(k, b, T + t)
                                                                 : nullptr};
          wait_flag_words<1>(ptr, flag);
          __syncwarp();
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int i = 0; i < TL; ++i) {
              const float ov = ld_rows1(so.x(c * R + pp, o0 + li0 + i));
              tv[c][i] = rank == 0 ? tv[c][i] + ov : ov + tv[c][i];
            }
        }
      }
      if (own && needed) {
        // the outputs first: a trace row that this step stores is read back
        // by this thread when the next step injects it
        if (ft.out != nullptr && !kNoOutputs) {
#pragma unroll
          for (int i = 0; i < TL; ++i) {
            ft.out[(size_t)pp * ld + o0 + li0 + i] = tv[0][i];
            ft.out[(size_t)(R + pp) * ld + o0 + li0 + i] = tv[1][i];
          }
        }
        if (has_next) {
          float nr[2][TL], nb[2][3][TL], eb[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
#pragma unroll
            for (int i = 0; i < TL; ++i) {
              nr[c][i] = pub[(c * TL + i) * 32 + lane];
#pragma unroll
              for (int d = 0; d < 3; ++d) nb[c][d][i] = pub[(2 * TL + (c * 3 + d) * TL + i) * 32 + lane];
            }
            eb[c] = pub[(8 * TL + c) * 32 + lane];
          }
          // the injection of the next step, + sign . cpl . (trace - trace_sub),
          // as the band's taps: inside the tile into the rows, across its
          // ends into the edge terms.  The trace row's lanes of this tile
          // were stored by this thread at the step that made them (the
          // outputs above): plain loads, program order
          float ir[2][TL], ie[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            ie[c] = 0.f;
#pragma unroll
            for (int i = 0; i < TL; ++i) ir[c][i] = 0.f;
          }
          if constexpr (kInject) {
            const FlowTile nx = items.tile(k + 1, b, t);
            if (nx.cpl != nullptr && nx.carry_step >= 0 && !kNoInjection) {
              float tw[2][TL];
#pragma unroll
              for (int c = 0; c < 2; ++c)
#pragma unroll
                for (int i = 0; i < TL; ++i) {
                  const int o = o0 + li0 + i;
                  float v = 0.f;
                  if (o < n) {
                    v = nx.trace_row[(size_t)(c * R + pp) * ld + o];
                    if (nx.trace_sub != nullptr)
                      v -= __ldg(nx.trace_sub + (size_t)(c * R + pp) * ld + o);
                  }
                  tw[c][i] = v;
                }
              float lw[2], rw[2];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                lw[c] = __shfl_up_sync(0xffffffffu, tw[c][TL - 1], 1);
                rw[c] = __shfl_down_sync(0xffffffffu, tw[c][0], 1);
              }
#pragma unroll
              for (int i = 0; i < TL; ++i) {
                const int l = li0 + i, o = o0 + l;
                float ar = 0.f, ai = 0.f;
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                  if (l + d - 1 < 0 || l + d - 1 >= kLanes) continue;
                  const int m = i + d - 1, mc = m < 0 ? 0 : (m >= TL ? TL - 1 : m);
                  const float tr = m < 0 ? lw[0] : m >= TL ? rw[0] : tw[0][mc];
                  const float ti = m < 0 ? lw[1] : m >= TL ? rw[1] : tw[1][mc];
                  const float br = __ldg(nx.cpl + (size_t)d * ld + o);
                  const float bi = __ldg(nx.cpl + (size_t)(3 + d) * ld + o);
                  ar = ar + br * tr - bi * ti;
                  ai = ai + br * ti + bi * tr;
                }
                ir[0][i] = nx.sign * ar;
                ir[1][i] = nx.sign * ai;
              }
              // lane o0 - 1: tap 2 of it on this tile's lane 0; lane o0 + 8:
              // tap 0 of it on lane 7
              if ((li0 == 0 && o0 >= 1) || (li0 + TL == kLanes && o0 + kLanes < ld)) {
                const bool lo_side = li0 == 0;
                const int o = lo_side ? o0 - 1 : o0 + kLanes, d = lo_side ? 2 : 0;
                const float tr = tw[0][lo_side ? 0 : TL - 1], ti = tw[1][lo_side ? 0 : TL - 1];
                const float br = __ldg(nx.cpl + (size_t)d * ld + o);
                const float bi = __ldg(nx.cpl + (size_t)(3 + d) * ld + o);
                ie[0] = nx.sign * (br * tr - bi * ti);
                ie[1] = nx.sign * (br * ti + bi * tr);
              }
            }
          }
          float lf[2], rt[2];                        // the neighbouring lanes' values
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            lf[c] = __shfl_up_sync(0xffffffffu, tv[c][TL - 1], 1);
            rt[c] = __shfl_down_sync(0xffffffffu, tv[c][0], 1);
          }
          // the value of tile lane li0 + m (m = -1 .. TL)
          auto tap = [&](int c, int m) {
            return m < 0 ? lf[c] : m >= TL ? rt[c] : tv[c][m < 0 ? 0 : (m >= TL ? TL - 1 : m)];
          };
#pragma unroll
          for (int i = 0; i < TL; ++i) {
            const int l = li0 + i;
            float ar = 0.f, ai = 0.f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              if (l + d - 1 < 0 || l + d - 1 >= kLanes || kNoBandStep) continue;
              const float tr = tap(0, i + d - 1), ti = tap(1, i + d - 1);
              ar = ar + nb[0][d][i] * tr - nb[1][d][i] * ti;
              ai = ai + nb[0][d][i] * ti + nb[1][d][i] * tr;
            }
            *so.p(pp, o0 + l) = (kInject ? nr[0][i] + ir[0][i] : nr[0][i]) - ar;
            *so.p(R + pp, o0 + l) = (kInject ? nr[1][i] + ir[1][i] : nr[1][i]) - ai;
          }
          // lane o0 - 1: tap 2 of it; lane o0 + 8: tap 0 of it (zero past the line)
          const int side = li0 == 0 ? 0 : 1;
          if (li0 == 0 || li0 + TL == kLanes) {
            const float tr = tv[0][side ? TL - 1 : 0], ti = tv[1][side ? TL - 1 : 0];
            const float er = kNoBandStep ? 0.f : eb[0] * tr - eb[1] * ti;
            const float ei = kNoBandStep ? 0.f : eb[0] * ti + eb[1] * tr;
            *(so.e(pp, t) + side) = kInject ? ie[0] - er : -er;
            *(so.e(R + pp, t) + side) = kInject ? ie[1] - ei : -ei;
          }
        }
        // the P flags, once the warp's rows are out: with one CTA a tile,
        // those of the CTA's tiles of a step and batch row together after the
        // last of them (the consumers wait for every tile of the line)
        if (has_next) {
          int fa = t, fb = t + 1;
          bool last = true;
          if (SPLIT == 1) {
            fa = ta;
            fb = tb;
            int k1 = -1, b1 = -1, t1 = 0;
            if (q + 1 < nitem) where(q + 1, k1, b1, t1);
            last = !(k1 == k && b1 == b);
          }
          if (last) {
            __syncwarp();
            if (!kNoFences) fence_acq_rel_gpu();
            for (int tt = fa + lane; tt < fb; tt += 32) st_word(flag_word(k, b, tt), 0.f, flag);
          }
        }
      }
      trace_point(q, 5, kPublisher * 32);
    }
  }
}

// A step map: the wide step at r = 4, 8, 16, else the narrow one
template <int R, Storage S, int SPLIT, bool kInject, class Items>
__device__ __forceinline__ void run_flow(const Items& items, const FlowLaunch& fl) {
  if constexpr (wide<R>())
    run_wide<R, S, SPLIT, kInject>(items, fl);
  else
    run_narrow<R, S, SPLIT, kInject>(items, fl);
}

template <int R, bool kBackward, Storage S, int SPLIT>
__device__ __forceinline__ void flow_wide(const FlowArgs& fa) {
  const PassArgs& a = fa.a;
  const PassMap<R, kBackward, S, false> map{
      a, FlowLaunch{a.count, a.batch, a.n, a.ld, fa.xchg, fa.epoch, nullptr, 0, kSlots, a.rows}};
  run_wide<R, S, SPLIT, false>(map, map.fl);
}

template <int R, bool kBackward, Storage S, bool kBanded, int SPLIT>
__global__ void __launch_bounds__(flow_threads<SPLIT>(), 512 / flow_threads<SPLIT>())
    pass_map_kernel(const PassMap<R, kBackward, S, kBanded> items) {
  run_flow<R, S, SPLIT, false>(items, items.fl);
}

// The narrow step on banded+tail pivots takes one exchange slot per line
// step (windows let CTAs run apart); the wide step, whose every CTA waits on
// its slice's tiles of the step before, the ring of kSlots
template <int R, bool kBackward, Storage S, bool kBanded>
inline cudaError_t launch_pass_map(const PassArgs& a, uint2* xchg, unsigned epoch,
                                   cudaStream_t stream) {
  using Map = PassMap<R, kBackward, S, kBanded>;
  const Map map{a, FlowLaunch{a.count, a.batch, a.n, a.ld, xchg, epoch, nullptr, 0,
                              kBanded && !wide<R>() ? 0 : kSlots, a.rows}};
  return launch_map<R, S, false, Map>(pass_map_kernel<R, kBackward, S, kBanded, 1>,
                                      pass_map_kernel<R, kBackward, S, kBanded, 2>, map,
                                      a.batch * (a.ld / kLanes), stream);
}

// A pass through run_flow: on banded+tail pivots (kBanded: bf16, 0 <
// tail_start < m, half >= 0, no scales), else on dense planes (bf16, or int8
// when scales are given); r = 1, 2, 4, 8 or 16.  The exchange needs one slot
// per line (count slots) at r <= 2 on banded+tail pivots, else kSlots
template <bool kBackward, Storage S, bool kBanded>
inline cudaError_t launch_pass_map_r(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                                     cudaStream_t stream) {
  switch (r) {
    case 1: return launch_pass_map<1, kBackward, S, kBanded>(a, xchg, epoch, stream);
    case 2: return launch_pass_map<2, kBackward, S, kBanded>(a, xchg, epoch, stream);
    case 4: return launch_pass_map<4, kBackward, S, kBanded>(a, xchg, epoch, stream);
    case 8: return launch_pass_map<8, kBackward, S, kBanded>(a, xchg, epoch, stream);
    case 16: return launch_pass_map<16, kBackward, S, kBanded>(a, xchg, epoch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBackward, bool kBanded = false>
inline cudaError_t run_map_pass(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                                cudaStream_t stream) {
  if (a.batch < 1 || a.m < 1 || a.n < 1 || a.ld < a.n || a.ld % kLanes != 0 ||
      !launch_width(r) || a.count < 1 || a.first < 0 || a.first >= a.m || xchg == nullptr ||
      epoch == 0u || epoch + (unsigned)a.count < epoch || (r > 2 && a.rows == nullptr))
    return cudaErrorInvalidValue;
  if constexpr (kBanded) {
    if (a.tail_start < 1 || a.tail_start >= a.m || a.half < 0 || a.scale != nullptr)
      return cudaErrorInvalidValue;
    return launch_pass_map_r<kBackward, Storage::kBf16, true>(r, a, xchg, epoch, stream);
  } else {
    if (a.scale != nullptr)
      return launch_pass_map_r<kBackward, Storage::kInt8, false>(r, a, xchg, epoch, stream);
    return launch_pass_map_r<kBackward, Storage::kBf16, false>(r, a, xchg, epoch, stream);
  }
}

}  // namespace thomas
