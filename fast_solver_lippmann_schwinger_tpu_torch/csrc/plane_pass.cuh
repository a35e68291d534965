// Plane-pivot substitution for the 3D block-Thomas solves: the body of the
// three plane kernels
//
//     plane::flow_kernel<R, false, S>   forward pass over a slab's planes   plane_fwd.cu
//     plane::flow_kernel<R, true, S>    backward pass                       plane_bwd.cu
//     plane::apply_kernel<R, S>         one plane apply [Yr; Yi] @ P[k]     plane_apply.cu
//
// which those files instantiate and launch, for S = Storage::kBf16 (bf16
// pivot planes) and S = Storage::kInt8 (int8 planes with f32 scales).  A 3D
// stencil matrix on an (l, a, b)
// grid is block tridiagonal over its z-planes: the pivot blocks are dense
// (mn x mn) inverses, mn = a b, and the couplings between planes are 9-tap
// in-plane stencils.  Per plane p (forward: start..l-1, backward: l-1..start)
// a pass computes
//
//     y_p = rhs_p - S_p(carry)            9-tap complex stencil, flat shifts
//     t_p = y_p . P[base + p]             [Yr; Yi] @ P, bf16 or int8 plane
//
// where carry is the t of the plane before (forward: p-1, backward: p+1).
// The forward pass takes its first carry from the caller (t_init, zero when
// absent) and keeps the y stack (for the backward pass) and, when asked, the
// t stack; the backward pass keeps its x stack (x_p = t_p).
//
// Numerics contract of the JAX package's Pallas kernels
// (sparse/pallas_plane.py: _sten_apply_rows, _dot_plane): planes widened to
// f32, f32 multiply-add and accumulation, f32 rows stacked
// [re_0..re_{r-1}; im_0..im_{r-1}], taps summed in the order (dj, di) =
// (-1,-1), (-1,0), ... (1,1).  An int8 entry of input row i and output lane o
// counts as q * scale[i / 128, o], dequantized element by element BEFORE the
// product, as the Pallas kernel does (pallas_plane.py:316-326; the XLA path
// of the JAX package scales each 128-row partial sum instead, direct.py
// _pivot_apply: the two differ in f32 rounding only).
//
// Layouts (the port's own, as for the 2D kernels): rows (l, 2r, ld) f32,
// stencil weight rows (l, 2, 9, ld) f32 ([re, im] x tap x lane, zero wherever
// the tap's target leaves the plane), pivot planes stored TRANSPOSED and
// tile-major, P[s, t, i_in, l] = Cinv_s^T[i_in, 8 t + l], so a tile of 8
// output lanes reads its input rows back to back: 16 bytes a row in bf16,
// 8 in int8.  bf16: ld = round_up(mn, 8).  int8: ld = round_up(mn, 128), so
// that the scale blocks of 128 input rows align, and the scales are
// tile-major too, scale[s, t, b, part, l] (part 0: real plane, 1: imaginary)
// for input block b and output lane 8 t + l.  Padding entries are zero with
// scale 1, and padding lanes are never read as sources (flat shifts: a
// source index outside [0, mn) has a zero weight and is skipped, where the
// TPU kernel rolls lanes around the padded row).
//
// The flag-handoff plane step (flow_kernel).  A plane step needs the whole
// y_p in every output tile, and y_p[f] needs the carry only at the lanes
// f + dj n + di.  The grid-barrier step these passes ran before shared the
// stencil out over the grid, met at a grid barrier, had every block stage
// the whole y_p, and met again: two barriers a plane, during which the pivot
// stream stopped (its ring held 3 chunks), at 2.8 (r = 1) and 4.1 (r = 2)
// times the bytes' time on int8 y-planes at ld = 3072 (PERF.md §5).  Here:
//
// 1. One persistent CTA an SM (a cooperative launch), owning a fixed run of
//    consecutive output tiles: tiles / CTAs, one more for the first
//    tiles % CTAs, so none takes more than ceil(tiles / CTAs): 3 at 384
//    tiles (ld = 3072, 2.91 on average).  Where that maximum is well above
//    the average (3 against 2.18 at 288 tiles, mn = 2304; 4 against 3.15 at
//    416) the step takes the maximum's time: sharing the input rows out
//    evenly instead (a tile split between two CTAs) measured about even at
//    288 tiles and slower at 384, and only paid at 416, a width no path
//    runs (PERF.md §6).  Eight consumer warps compute; a ninth warp streams.
//
// 2. A deep pivot ring filled by bulk copies.  The producer warp walks the
//    CTA's chunks in order (plane step, tile, chunk of C input rows): one
//    cp.async.bulk per plane part and one for the chunk's int8 scales, into
//    slot g % N, completing on the slot's `full` mbarrier; it refills a slot
//    once each consumer warp has arrived on its `empty` mbarrier.  The pivot
//    bytes do not depend on the carry, so the producer runs on across tiles
//    and planes while the consumers wait: N is sized per launch from the
//    shared memory the staged y_p leaves (at ld = 3072 in int8, 10 to 12
//    slots of 1024 rows, a whole step's share of a CTA), at least 4 slots at
//    the widest planes the wrappers send here (sparse/plane_kernels.py,
//    fused_fits, whose widths are unchanged).  Within a chunk the warps take
//    64-row segments in turn, two rows a lane, so that they share the rows
//    evenly and each segment lies in one 128-row scale block (one broadcast
//    read of its scales).
//
// 3. One grid-wide wait a plane, and the stencil local.  Tiles of t_p and
//    lanes of y_p travel as 8-byte exchange words (value bits, flag), the
//    low-latency form of NCCL's LL protocol (as in thomas_flow.cuh): an
//    aligned 8-byte store is seen whole or not at all, so a reader whose
//    flag matches has its value.  Per plane step s (flag epoch + s):
//      (a) each CTA forms y_s of its own lanes from the t_{s-1} words of the
//          lanes within +-(n + 1) (a local wait on about 13 tiles either
//          side at n = 96), its weights and its right-hand rows, and
//          publishes them as y words (and, forward, into the y stack);
//      (b) every CTA reads all y_s words into shared memory, polling their
//          flags: the one grid-wide wait;
//      (c) each CTA computes its tiles of t_s from the ring and publishes
//          them as t words (and into the t or x stack).
//    y words live in two slots (slot s & 1): a CTA that writes y_{s+2} has
//    read t_{s+1} from its neighbours, who read every y_{s+1} word, each
//    published after its writer had read all of y_s.  t words live in two
//    slots too.  The grid-wide wait alone would let one do (a CTA writes
//    t_{s+1} after reading every y_{s+1} word, each published after its
//    writer had read its taps' t_s words), but the probe's build without y
//    staging has no grid-wide wait; two slots hold without it: a CTA writes
//    t_{s+2} after reading t_{s+1} of every neighbour, each written after
//    that neighbour had read its t_s (the taps are symmetric, so the CTAs
//    that read a tile are the ones it reads).  Flags come from the
//    wrapper's launch counter (thomas_kernels.Exchange: a counter that only
//    grows over a buffer zeroed once), so no stale word carries a current
//    flag and no memset runs per launch; a poll traps after 2^24 tries
//    instead of holding the card.  Sums are added in a fixed order (no
//    atomics), so a pass is bit-identical from run to run.
//
// Bound: bytes.  A plane step must read the two planes once: 2 x ld^2 x 2 B
// in bf16 (21.2 MB at mn = 2304, 6.3 us at the card's 3.35 TB/s), 2 x ld^2 B
// plus 2 x ld^2 / 128 x 4 B of scales in int8 (19.5 MB at ld = 3072, 5.8 us);
// the weight rows and the row stacks add about 1 %.  The arithmetic is
// 2 x 2r x 2 x ld^2 flop, far below the f32 rate; int8 adds a widening and a
// scaling per element (about 3 ld^2 more operations at r = 1), which stays
// below it.  The y words add 2r x ld x 8 B of L2 reads per CTA a step (the
// wide step's plain rows 2r x ld x 4 B, note 4).
//
// 4. Wide batches: r = 4 and 8 in one launch, on tensor cores (flow_wide).
//    The TPU kernels take any r in one pass, each pivot plane read once for
//    all of them (pallas_plane.py, _fwd_slab_call: (Pe, r2, npad) rows).  The
//    f32 step above keeps 2r x 8 sums a thread (128 at r = 8), so at r = 4
//    and 8 the products run as mma.sync.m16n8k16 (bf16 in, f32 sums;
//    wide_mma.cuh): y split into three bf16 terms y = h + m + l (about 24
//    bits, f32's precision; two would leave 16, TF32 10), every k-step on
//    fresh sums added in f32, each int8 k-step's partial multiplied by its
//    128-row block's scale before it is added (the TPU kernel's order,
//    _dot_plane: f32 rounding apart, the plain version's numbers).  A first
//    version of this step took 3.4 - 3.7 x its r = 2 time: on int8 planes at
//    ld = 3072 an r = 8 step took 56.8 us, by ablation 25 in the products (y
//    split again for every tile and k-step, B fragments built an entry at a
//    time), 17 in the y staging (every CTA read 2r x ld flagged 8-byte
//    words) and 13 in the stencil (24 threads a CTA, four rounds of polls;
//    PERF.md section 6).  This step:
//    - y_p travels as plain f32 rows, not as flagged words: the forward pass
//      writes its y stack, the backward pass a two-plane scratch; a CTA
//      publishes one flag word a step once its lanes are written (a consumer
//      barrier, then one thread's fence and the flag, as a grid barrier
//      publishes its arrivals), and a warp reads y_p after its lanes have
//      seen every CTA's flag, polled all at once with acquire loads: half the
//      bytes of the words, coalesced.
//    - No CTA stages y_p whole.  A warp takes the k-steps (16 input rows)
//      warp, warp + 8, ... of the plane, copies each one's 2r x 16 floats
//      (cp.async) kYDepth - 1 k-steps ahead into a few KB of its own, splits
//      them once and multiplies them into every tile of its CTA (at most
//      max_tiles; the tile loop a template on the tile count, so that the
//      tiles' products overlap), so the pivot ring gets the shared memory
//      y_p took: 6 slots of 25 KB at ld = 3072, r = 8, where the staged y_p
//      left 4 of 6 KB.  A warp counts its chunks and slots (no division a
//      k-step).
//    - The ring holds chunks in the order (plane step, chunk of C rows), a
//      slot holding the chunk's rows of all the CTA's tiles.
//    - B fragments: bf16 by one ldmatrix.x4.trans (both parts, 16 rows), int8
//      a byte an entry, widened by a byte permute and a subtraction.
//    - r = 4 fills M: rows 0-7 take the h term of the 8 rows, rows 8-15 the
//      m term, a second product the l term: two products a part, not three.
//    - The stencil of (a) runs a thread per lane and pair of right-hand sides
//      (r / 2 threads a lane): one round of polls.
//    - After a step's products the warps' sums meet in shared memory (two
//      parities, one consumer barrier) and the consumer threads add them in
//      warp order and publish the tiles.
//    r = 1 and 2 keep the f32 step above.  The plane apply takes the same
//    products at r = 4 and 8 (apply_kernel(ApplyArgs)): a block of 8
//    consumer warps and a producer warp owns up to max_tiles consecutive
//    tiles, one wave of blocks, its y the rows in global memory.
//
// Limits.  r = 1, 2, 4 or 8 (the wrappers pad r = 3 to 4 and r = 5..7 to 8
// with zero columns and run more than 8 as groups of 8), and planes whose
// staged y_p (2r x ld floats, r <= 2) leaves room for 4 slots: the fused
// passes take ld <= 12448 at r = 2 (24928 at r = 1) in bf16, 12288 (24704)
// in int8 (fused_fits, which stays with the grid-barrier step's widths).  At
// r = 4 and 8 fused_fits takes fixed widths: 6352 and 3104 in bf16, 6272
// and 3072 in int8; the wide step takes them (at least 2 ring slots, at most
// max_tiles tiles a CTA).  The plane apply reads
// its rows from global memory and has no such bound (the wrappers send larger
// stacks to the per-plane path).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "thomas_flow.cuh"

namespace plane {

constexpr int kThreads = 128;          // threads per block (plane apply)
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;              // output lanes per tile
constexpr int kChunkBytes = 4096;      // bytes of one plane's tile per staged chunk
constexpr int kStages = 4;             // chunks in the ring
constexpr int kMaxRhs = 8;             // right-hand sides per launch: 1, 2, 4 or 8

// The widths a plane launch is instantiated for: the line kernels' own
// predicate (thomas::launch_width) also takes 16, which no plane kernel has
__host__ __device__ constexpr bool launch_width(int r) {
  return r == 1 || r == 2 || r == 4 || r == 8;
}
constexpr int kTaps = 9;
constexpr int kScaleBlock = 128;       // input rows per int8 scale

enum class Storage : int { kBf16 = 0, kInt8 = 1 };

// What a storage puts into a chunk of the ring: one tile's input rows of both
// planes and, for int8, their scales ([block][part][lane] floats)
template <Storage S>
struct Store {
  static constexpr int kRowBytes = S == Storage::kInt8 ? 8 : 16;   // kLanes values
  static constexpr int kChunkRows = kChunkBytes / kRowBytes;       // 256 or 512
  static constexpr int kBlocks = S == Storage::kInt8 ? kChunkRows / kScaleBlock : 0;
  static constexpr int kScaleBytes = kBlocks * 2 * kLanes * 4;     // 0 or 256
  static constexpr int kSlotBytes = 2 * kChunkBytes + kScaleBytes;
  static constexpr size_t kRingBytes = (size_t)kStages * kSlotBytes;
};
static_assert(kThreads == kScaleBlock, "int8 pass j of a chunk is scale block j");

// Timing by ablation (benchmarks_torch/plane_probe.py): a build with
// -DPLANE_ABLATE=<mask> leaves single phases of a plane step out.  Its results
// are wrong and only its time is read; the package always builds with 0.
// Bits: no synchronisation (the flag waits: words read once, flags
// unchecked), no stencil (y = rhs), no pivot stream (no copies, the products
// read stale slots), no y staging (no y words read: no grid-wide wait
// either), no products.
#ifndef PLANE_ABLATE
#define PLANE_ABLATE 0
#endif
constexpr bool kNoSync = PLANE_ABLATE & 1;
constexpr bool kNoStencil = PLANE_ABLATE & 2;
constexpr bool kNoStream = PLANE_ABLATE & 4;
constexpr bool kNoStage = PLANE_ABLATE & 8;
constexpr bool kNoProducts = PLANE_ABLATE & 16;

template <int R>
__host__ __device__ constexpr size_t red_bytes() {
  return sizeof(float) * kWarps * 2 * R * kLanes;
}


__device__ __forceinline__ void widen_bf16x8(const uint4 v, float* f) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
  f[4] = __uint_as_float(v.z << 16);
  f[5] = __uint_as_float(v.z & 0xffff0000u);
  f[6] = __uint_as_float(v.w << 16);
  f[7] = __uint_as_float(v.w & 0xffff0000u);
}

// 8 int8 values -> floats: (q ^ 0x80) = q + 128 as an unsigned byte, placed
// in the low mantissa bits of 2^23 by one byte-permute; subtracting 2^23 + 128
// leaves q exactly.  (The card converts 16 values per clock and SM with its
// conversion instruction, fewer than the plane's bytes arrive.)
__device__ __forceinline__ void widen_s8x8(const uint2 v, float* f) {
  const unsigned a = v.x ^ 0x80808080u, b = v.y ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = __uint_as_float(__byte_perm(a, 0x4B000000u, 0x7650u | k)) - 8388736.f;
    f[4 + k] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7650u | k)) - 8388736.f;
  }
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// The block's stream of pivot-tile chunks (plane apply).  Work item
// q is output tile blockIdx.x + k gridDim.x of plane first + dir (q /
// tiles_blk), k = q % tiles_blk; chunk c of an item covers input rows
// [c kChunkRows, (c+1) kChunkRows).  Chunk g = q nch + c goes to ring slot
// g % kStages.
template <Storage S>
struct TileStream {
  using St = Store<S>;
  const unsigned char* pre;    // planes, one tile's input rows back to back
  const unsigned char* pim;
  const float* scale;          // int8: (SL, ld/8, nb, 2, 8) tile-major scales
  unsigned char* ring;         // [kStages][kSlotBytes]
  int ld, tiles_row, nch, total;
  int first, dir, tiles_blk;

  __device__ int plane_of(int q) const { return first + dir * (q / tiles_blk); }
  __device__ int tile_of(int q) const {
    return (int)blockIdx.x + (q % tiles_blk) * (int)gridDim.x;
  }
  __device__ unsigned char* slot(int g) const {
    return ring + (size_t)(g % kStages) * St::kSlotBytes;
  }

  // request chunk g (nothing past the end); always one commit group, so that
  // the groups in flight count chunks
  __device__ void request(int g) const {
    if (g < total && !kNoStream) {
      const int q = g / nch, c = g - q * nch;
      const size_t tile = (size_t)plane_of(q) * tiles_row + tile_of(q);
      const int row0 = c * St::kChunkRows;
      const int rows = min(St::kChunkRows, ld - row0);
      const size_t off = (tile * ld + row0) * St::kRowBytes;
      unsigned char* sre = slot(g);
      unsigned char* sim = sre + kChunkBytes;
      for (int i = threadIdx.x; i < rows * St::kRowBytes / 16; i += kThreads) {
        cp_async16(sre + 16 * i, pre + off + 16 * i);
        cp_async16(sim + 16 * i, pim + off + 16 * i);
      }
      if (S == Storage::kInt8) {
        // the chunk's rows / 128 scale blocks, 2 x 8 floats each
        const int nb = ld / kScaleBlock;
        const float* src = scale + (tile * nb + row0 / kScaleBlock) * 2 * kLanes;
        for (int i = threadIdx.x; i < rows / kScaleBlock * 4; i += kThreads)
          cp_async16(sim + kChunkBytes + 16 * i, src + 4 * i);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
};

// One input row's 8 lanes of both planes as floats: bf16 row i of a chunk
// whose imaginary plane part lies `im` bytes after the real one, or int8 row
// i, dequantized element by element with the scales of its 128-row block
// ([part][lane] floats at `sb`)
template <Storage S>
__device__ __forceinline__ void load_row(const unsigned char* sre, int im, const float* sb,
                                         int i, float* cr, float* ci) {
  const unsigned char* sim = sre + im;
  if (S == Storage::kBf16) {
    widen_bf16x8(reinterpret_cast<const uint4*>(sre)[i], cr);
    widen_bf16x8(reinterpret_cast<const uint4*>(sim)[i], ci);
  } else {
    widen_s8x8(reinterpret_cast<const uint2*>(sre)[i], cr);
    widen_s8x8(reinterpret_cast<const uint2*>(sim)[i], ci);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      cr[l] *= sb[l];
      ci[l] *= sb[kLanes + l];
    }
  }
}

// One output tile (plane apply): stream its nch chunks (chunk
// counter g runs on), multiply by the rows y (2R x ld floats, shared or
// global memory), reduce over the block and write the 2R x 8 results to
// out[qq ld + o0 + l].
template <int R, Storage S>
__device__ __forceinline__ void tile_product(const TileStream<S>& ts, int& g, const float* y,
                                             float* red, float* out, int o0) {
  using St = Store<S>;
  const int tid = threadIdx.x;
  const int ld = ts.ld;
  float zre[2 * R][kLanes], zim[2 * R][kLanes];
#pragma unroll
  for (int qq = 0; qq < 2 * R; ++qq)
#pragma unroll
    for (int l = 0; l < kLanes; ++l) zre[qq][l] = zim[qq][l] = 0.f;

  for (int c = 0; c < ts.nch; ++c, ++g) {
    // chunk g has landed once at most kStages - 2 newer groups are pending;
    // the barrier also frees slot (g - 1) % kStages for the next request
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    ts.request(g + kStages - 1);
    const unsigned char* sre = ts.slot(g);
    const float* sc = reinterpret_cast<const float*>(sre + 2 * kChunkBytes);
    const int row0 = c * St::kChunkRows;
    const int rows = kNoStream ? 0 : min(St::kChunkRows, ld - row0);
#pragma unroll 2
    for (int i = tid; i < rows; i += kThreads) {
      float cr[kLanes], ci[kLanes];
      load_row<S>(sre, kChunkBytes, sc + (i / kScaleBlock) * 2 * kLanes, i, cr, ci);
#pragma unroll
      for (int qq = 0; qq < 2 * R; ++qq) {
        const float wq = y[qq * ld + row0 + i];
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          zre[qq][l] += wq * cr[l];
          zim[qq][l] += wq * ci[l];
        }
      }
    }
  }

  // complex recombination (linear, so it commutes with the reduction):
  // t_re = Yr.Pre - Yi.Pim,  t_im = Yi.Pre + Yr.Pim
  float t[2 * R][kLanes];
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      t[p][l] = zre[p][l] - zim[R + p][l];
      t[R + p][l] = zre[R + p][l] + zim[p][l];
    }
#pragma unroll
  for (int qq = 0; qq < 2 * R; ++qq)
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      float v = t[qq][l];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      t[qq][l] = v;
    }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int qq = 0; qq < 2 * R; ++qq)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) red[(tid >> 5) * 2 * R * kLanes + qq * kLanes + l] = t[qq][l];
  }
  __syncthreads();
  if (tid < 2 * R * kLanes) {
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[wi * 2 * R * kLanes + tid];
    out[(tid / kLanes) * ld + o0 + tid % kLanes] = v;
  }
}

struct PassArgs {
  const float* rhs;        // (l, 2r, ld): b (forward) or y (backward)
  const float* w;          // (l, 2, 9, ld) stencil weight rows
  const void* pre;         // (SL, ld/8, ld, 8) bf16 bits or int8, tile-major,
  const void* pim;         //   transposed pivot planes
  const float* scale;      // int8: (SL, ld/8, nb, 2, 8) scales; bf16: null
  const float* t_init;     // forward: (2r, ld) carry into plane `start`, or
                           //   null for a zero carry; backward: unused
  float* kept;             // forward: y stack (l, 2r, ld), planes >= start;
                           //   backward: r = 4, 8: two-plane scratch (2, 2r, ld)
                           //   of the planes' y rows
  float* out;              // t stack (forward; may be null) or x stack
                           //   (backward), (l, 2r, ld), planes >= start
  int l, mn, n, ld;        // n: the plane's fast axis, for the flat shifts
  int base;                // pivot plane of plane p is base + p
  int start;               // planes start..l-1 are computed
};

// ---------------------------------------------------------------------------
// The flag-handoff plane step (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kFlowWarps = 8;                        // consumer warps
constexpr int kFlowConsumers = kFlowWarps * 32;
constexpr int kFlowThreads = kFlowConsumers + 32;    // and the producer warp
constexpr int kWordSlots = 2;                        // slots of y words, of t words
constexpr int kMinSlots = 4, kMaxSlots = 64;         // ring slots
constexpr int kRedPitch = kFlowWarps + 4;            // floats a value's warp sums take
// rows a warp takes of a chunk at a time, kLaneRows a lane (four measured
// slower, PERF.md §6); a segment lies within a 128-row scale block
constexpr int kSegRows = 64;
constexpr int kLaneRows = kSegRows / 32;
// 16-byte y words a thread polls at once: all of them at ld = 3072
template <int R>
__host__ __device__ constexpr int gather_batch() { return 12 * R; }
// wide batches (note 4): the tensor-core step
template <int R>
__host__ __device__ constexpr bool wide() { return R > 2; }
// bytes of one ring slot of `rows` input rows: both plane parts and, int8,
// the scales of their rows / 128 blocks
template <Storage S>
__host__ __device__ constexpr size_t flow_slot_bytes(int rows) {
  return (size_t)2 * rows * Store<S>::kRowBytes +
         (S == Storage::kInt8 ? (size_t)rows / kScaleBlock * 2 * kLanes * sizeof(float) : 0);
}

// the warps' sums of a tile's 2R x 8 values, two parities
template <int R>
__host__ __device__ constexpr size_t flow_red_bytes() {
  return sizeof(float) * 2 * (2 * R * kLanes) * kRedPitch;
}

__host__ __device__ constexpr size_t flow_bar_bytes(int slots) {
  return ((size_t)16 * slots + 127) / 128 * 128;      // full and empty mbarriers
}

// shared memory of a flag-step pass: the mbarriers, the warps' sums, the
// staged y_p, the ring
template <int R, Storage S>
__host__ __device__ constexpr size_t flow_smem_bytes(int ld, int rows, int slots) {
  return flow_bar_bytes(slots) + flow_red_bytes<R>() + sizeof(float) * (size_t)2 * R * ld +
         (size_t)slots * flow_slot_bytes<S>(rows);
}

// The chunk rows and slots of a launch: the largest chunk (a multiple of 32
// rows, of 128 in int8) whose ring still takes 8 slots, else the smallest,
// with as many slots as fit (at least kMinSlots, else false: plane too wide)
template <int R, Storage S>
inline bool flow_ring(int ld, size_t optin, int& rows, int& slots) {
  constexpr int kRows[3] = {S == Storage::kInt8 ? 1024 : 512, S == Storage::kInt8 ? 512 : 256,
                           S == Storage::kInt8 ? 384 : 192};
  const size_t fixed = flow_red_bytes<R>() + sizeof(float) * (size_t)2 * R * ld + 128;
  for (int k = 0; k < 3; ++k) {
    const size_t slot = flow_slot_bytes<S>(kRows[k]);
    if (fixed + kMinSlots * (slot + 16) > optin) continue;
    const int fit = (int)((optin - fixed) / (slot + 16));
    if (fit >= 8 || k == 2) {
      rows = kRows[k];
      slots = fit < kMaxSlots ? fit : kMaxSlots;
      return flow_smem_bytes<R, S>(ld, rows, slots) <= optin;
    }
  }
  return false;
}

struct FlowArgs {
  PassArgs a;
  uint2* xchg;             // (2 slots each of y and t words) x (ld, 2r) words
  unsigned epoch;          // flag of the first plane step
  int rows;                // input rows of a ring chunk
  int slots;               // chunks in the ring
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(thomas::smem_addr(bar))
               : "memory");
}

// waits for the phase of `bar` with this parity.  kBounded (the consumers'
// wait for a chunk's bytes): a wait longer than any copy can take (2^20
// tries, each suspending the thread for a while) means a copy will never
// land: the kernel traps instead of holding the card.  The producer's wait
// for a free slot has no bound of its own: the consumer warps it waits for
// either arrive or trap in one of their own bounded waits (a poll, a chunk),
// and a trap ends the grid.
template <bool kBounded>
__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done = 0;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(thomas::smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (kBounded && tries > (1u << 20)) __trap();
  }
}

// a barrier of the consumer warps only (the producer warp runs on)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kFlowConsumers) : "memory");
}

// The f32 step (r = 1, 2)
template <int R, bool kBackward, Storage S>
__device__ __forceinline__ void flow_narrow(const FlowArgs& fa) {
  using St = Store<S>;
  constexpr int V = 2 * R * kLanes;      // output values of a tile: rows x lanes
  constexpr int NW = 2 * R;              // words a lane: its 2R rows
  constexpr int kPitch = kRedPitch;
  const PassArgs& a = fa.a;
  const int ld = a.ld, mn = a.mn;
  const int yp = ld;                     // row pitch of the staged y_p
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int count = a.l - a.start;
  const size_t row = (size_t)2 * R * ld;     // floats per plane of a stack
  const int tiles_row = ld / kLanes;

  // this CTA's tiles tile0 .. tile0 + nt - 1, lanes f0 .. f0 + nf - 1: it
  // forms their y and publishes their t
  const int G = (int)gridDim.x, c = (int)blockIdx.x;
  const int nt = tiles_row / G + (c < tiles_row % G);
  const int tile0 = c * (tiles_row / G) + min(c, tiles_row % G);
  const int f0 = tile0 * kLanes, nf = nt * kLanes;
  const int C = fa.rows, N = fa.slots;
  const size_t slot_bytes = flow_slot_bytes<S>(C);
  const int im_off = C * St::kRowBytes;      // imaginary part within a slot

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + N;
  float* red = reinterpret_cast<float*>(smem + flow_bar_bytes(N));
  float* s_y = red + 2 * V * kPitch;                                     // [2R][yp]
  unsigned char* ring = reinterpret_cast<unsigned char*>(s_y + 2 * R * yp);

  if (tid == 0) {
    for (int i = 0; i < N; ++i) {
      thomas::mbar_init(full + i, 1);
      thomas::mbar_init(empty + i, kFlowWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // --- the producer warp: every chunk of the launch in order -------------
  if (warp == kFlowWarps) {
    if (lane == 0) {
      const unsigned char* pre = static_cast<const unsigned char*>(a.pre);
      const unsigned char* pim = static_cast<const unsigned char*>(a.pim);
      int g = 0;
      for (int s = 0; s < count; ++s) {
        const int p = kBackward ? a.l - 1 - s : a.start + s;
        for (int k = 0; k < nt; ++k) {
          const size_t tile = (size_t)(a.base + p) * tiles_row + tile0 + k;
          for (int row0 = 0; row0 < ld; row0 += C, ++g) {
            const int sl = g % N;
            if (g >= N) wait_phase<false>(empty + sl, (unsigned)(g / N - 1) & 1u);
            const int rows = min(C, ld - row0);
            const unsigned pb = (unsigned)rows * St::kRowBytes;
            const unsigned sb = S == Storage::kInt8
                                    ? (unsigned)(rows / kScaleBlock * 2 * kLanes * sizeof(float))
                                    : 0u;
            thomas::mbar_expect_tx(full + sl, kNoStream ? 0u : 2 * pb + sb);
            if (kNoStream) continue;
            unsigned char* dst = ring + (size_t)sl * slot_bytes;
            const size_t off = (tile * ld + row0) * St::kRowBytes;
            thomas::bulk_copy(dst, pre + off, pb, full + sl);
            thomas::bulk_copy(dst + im_off, pim + off, pb, full + sl);
            if (S == Storage::kInt8)
              thomas::bulk_copy(
                  dst + 2 * im_off,
                  a.scale + (tile * (ld / kScaleBlock) + row0 / kScaleBlock) * 2 * kLanes, sb,
                  full + sl);
          }
        }
      }
    }
    return;
  }

  // --- the consumer warps ---------------------------------------------------
  int offs[kTaps];                         // flat offsets of the taps: dj n + di
#pragma unroll
  for (int d = 0; d < kTaps; ++d) offs[d] = (d / 3 - 1) * a.n + (d % 3 - 1);
  auto y_words = [&](int s) { return fa.xchg + (size_t)(s & 1) * ld * NW; };
  auto t_words = [&](int s) { return fa.xchg + (size_t)(kWordSlots + (s & 1)) * ld * NW; };
  auto plane_of = [&](int s) { return kBackward ? a.l - 1 - s : a.start + s; };

  // thread tid < nf forms y of lane f = f0 + tid; what that needs but the
  // carry (its right-hand rows and weights) it loads one step ahead, before
  // the products, so that (a) waits on the carry's words alone
  const int f = f0 + tid;
  const bool my_lane = tid < nf && f < mn;
  float rb[2 * R], wr[kTaps], wi[kTaps];
  auto prefetch = [&](int s) {
    if (!my_lane || s >= count) return;
    const int p = plane_of(s);
    const float* rhs = a.rhs + (size_t)p * row;
    const float* w = a.w + (size_t)p * 2 * kTaps * ld;
#pragma unroll
    for (int rr = 0; rr < 2 * R; ++rr) rb[rr] = __ldg(rhs + rr * ld + f);
#pragma unroll
    for (int d = 0; d < kTaps; ++d) {
      wr[d] = __ldg(w + d * ld + f);
      wi[d] = __ldg(w + (kTaps + d) * ld + f);
    }
  };
  prefetch(0);

  int g = 0;      // chunk counter
  int q = 0;      // tile counter (parity of the warps' sums)
  for (int s = 0; s < count; ++s) {
    const int p = plane_of(s);
    const unsigned flag = fa.epoch + (unsigned)s;

    // (a) y_s of this CTA's lanes, from the right-hand rows and the carry:
    //     t_{s-1} words of the lanes within +-(n + 1), or t_init at s = 0
    if (tid < nf) {
      float y[2 * R];
#pragma unroll
      for (int rr = 0; rr < 2 * R; ++rr) y[rr] = my_lane ? rb[rr] : 0.f;
      const bool from_init = s == 0 && !kBackward && a.t_init != nullptr;
      if (my_lane && (s > 0 || from_init) && !kNoStencil) {
        // the carry's rows at each tap (zero weight outside the plane)
        float cv[kTaps][2 * R];
        if (from_init) {
#pragma unroll
          for (int d = 0; d < kTaps; ++d) {
            const int src = f + offs[d];
#pragma unroll
            for (int rr = 0; rr < 2 * R; ++rr)
              cv[d][rr] = src >= 0 && src < mn ? __ldg(a.t_init + rr * ld + src) : 0.f;
          }
        } else {
          const uint2* tw = t_words(s - 1);
          const uint2* ptr[kTaps * R];
#pragma unroll
          for (int d = 0; d < kTaps; ++d) {
            const int src = f + offs[d];
#pragma unroll
            for (int h = 0; h < R; ++h)
              ptr[d * R + h] = src >= 0 && src < mn ? tw + ((size_t)src * NW + 2 * h) : nullptr;
          }
          uint4 v[kTaps * R];
          thomas::poll_words<kTaps * R, !kNoSync>(ptr, v, flag - 1u);
#pragma unroll
          for (int d = 0; d < kTaps; ++d)
#pragma unroll
            for (int h = 0; h < R; ++h) {
              const bool in = ptr[d * R + h] != nullptr;
              cv[d][2 * h] = in ? __uint_as_float(v[d * R + h].x) : 0.f;
              cv[d][2 * h + 1] = in ? __uint_as_float(v[d * R + h].z) : 0.f;
            }
        }
        float accr[R], acci[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) accr[rr] = acci[rr] = 0.f;
#pragma unroll
        for (int d = 0; d < kTaps; ++d) {
          const int src = f + offs[d];
          if (src < 0 || src >= mn) continue;      // zero weight: never read
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const float tr = cv[d][rr], ti = cv[d][R + rr];
            accr[rr] = accr[rr] + wr[d] * tr - wi[d] * ti;
            acci[rr] = acci[rr] + wr[d] * ti + wi[d] * tr;
          }
        }
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          y[rr] -= accr[rr];
          y[R + rr] -= acci[rr];
        }
      }
      uint2* yw = y_words(s) + (size_t)f * NW;
#pragma unroll
      for (int rr = 0; rr < 2 * R; ++rr) thomas::st_word(yw + rr, y[rr], flag);
      if (!kBackward) {
        float* yk = a.kept + (size_t)p * row;
#pragma unroll
        for (int rr = 0; rr < 2 * R; ++rr) yk[rr * ld + f] = y[rr];
      }
    }
    __syncwarp();       // a warp's lanes past (a) poll together in (b)

    // (b) the whole y_s into shared memory: every CTA's words, polled until
    //     their flags match (the one grid-wide wait of the step).  Every
    //     consumer warp is past the last tile of step s - 1: s_y is free.
    {
      const uint2* yw = y_words(s);
      const int loads = kNoStage ? 0 : ld * R;     // 16-byte loads: lane f, rows 2h, 2h + 1
      constexpr int kBatch = gather_batch<R>();
      for (int i0 = 0; i0 < loads; i0 += kFlowConsumers * kBatch) {
        uint4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + tid + u * kFlowConsumers;
          v[u] = i < loads ? thomas::ld_words(yw + 2 * (size_t)i) : make_uint4(0u, flag, 0u, flag);
        }
        for (unsigned polls = 0; !kNoSync; ++polls) {
          bool ready = true;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) ready = ready && thomas::words_ready(v[u], flag);
          if (ready) break;
          if (polls > (1u << 24)) __trap();
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + tid + u * kFlowConsumers;
            if (!thomas::words_ready(v[u], flag)) v[u] = thomas::ld_words(yw + 2 * (size_t)i);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + tid + u * kFlowConsumers;
          if (i >= loads) continue;
          const int fi = i / R, h = i - fi * R;
          s_y[(2 * h) * yp + fi] = __uint_as_float(v[u].x);
          s_y[(2 * h + 1) * yp + fi] = __uint_as_float(v[u].z);
        }
      }
    }
    consumer_sync();
    prefetch(s + 1);

    // (c) this CTA's tiles of t_s: chunks from the ring, the warps' sums
    //     added in warp order, published as t words and into the t / x stack
    float* t_out = a.out != nullptr ? a.out + (size_t)p * row : nullptr;
    for (int k = 0; k < nt; ++k, ++q) {
      float* part = red + (q & 1) * V * kPitch;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      for (int row0 = 0; row0 < ld; row0 += C, ++g) {
        const int sl = g % N;
        wait_phase<true>(full + sl, (unsigned)(g / N) & 1u);
        const unsigned char* sre = ring + (size_t)sl * slot_bytes;
        const float* sc = reinterpret_cast<const float*>(sre + 2 * im_off);
        const int rows = min(C, ld - row0);
        // this warp's segments of the chunk, kSegRows rows each, in turn with
        // the chunk counter, so that a chunk of fewer segments than warps
        // leaves another warp idle each time; a lane takes rows lane and
        // lane + 32 of a segment (one 128-row scale block in int8: chunks
        // start at multiples of 128)
        const int seg0 = ((warp - g) % kFlowWarps + kFlowWarps) % kFlowWarps * kSegRows;
        for (int il = seg0 + lane; il - lane < rows && !kNoProducts;
             il += kSegRows * kFlowWarps) {
          const float* sb = sc + (il - lane) / kScaleBlock * 2 * kLanes;
          float cr[kLaneRows][kLanes], ci[kLaneRows][kLanes];
#pragma unroll
          for (int u = 0; u < kLaneRows; ++u) {
            const int iu = il + 32 * u;
            if (iu < rows) {
              load_row<S>(sre, im_off, sb, iu, cr[u], ci[u]);
            } else {
#pragma unroll
              for (int l = 0; l < kLanes; ++l) cr[u][l] = ci[u][l] = 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kLaneRows; ++u) {
            const float* yi = s_y + min(row0 + il + 32 * u, ld - 1);
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
              const float yr = yi[rr * ld], yim = yi[(R + rr) * ld];
#pragma unroll
              for (int l = 0; l < kLanes; ++l) {    // two fused multiply-adds a value
                float& tr = acc[rr * kLanes + l];
                float& ti = acc[(R + rr) * kLanes + l];
                tr = fmaf(yr, cr[u][l], tr);
                tr = fmaf(-yim, ci[u][l], tr);
                ti = fmaf(yim, cr[u][l], ti);
                ti = fmaf(yr, ci[u][l], ti);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + sl);       // this warp is done with the slot
      }
      const float sum = thomas::warp_transpose_sum<V>(acc);
      if (lane % (32 / V) == 0) part[(lane / (32 / V)) * kPitch + warp] = sum;
      consumer_sync();
      // the last warp adds the warps' sums and publishes the tile
      if (warp == kFlowWarps - 1) {
        for (int vi = lane; vi < V; vi += 32) {
          const float4* sums = reinterpret_cast<const float4*>(part + vi * kPitch);
          float v = 0.f;
#pragma unroll
          for (int c4 = 0; c4 < kFlowWarps / 4; ++c4) {     // in warp order
            const float4 f4 = sums[c4];
            v += f4.x;
            v += f4.y;
            v += f4.z;
            v += f4.w;
          }
          const int rr = vi / kLanes, o = (tile0 + k) * kLanes + vi % kLanes;
          if (t_out != nullptr) t_out[rr * ld + o] = v;
          thomas::st_word(t_words(s) + (size_t)o * NW + rr, v, flag);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The wide step (r = 4, 8; note 4)
// ---------------------------------------------------------------------------

constexpr int kYDepth = 4;             // k-steps of y a warp holds staged
template <int R>
__host__ __device__ constexpr int max_tiles() { return R == 8 ? 4 : 8; }
// floats of a warp's staged y: kYDepth k-steps of 2R rows of 16 columns
template <int R>
__host__ __device__ constexpr int y_stage_floats() { return kYDepth * 2 * R * wide::kYPitch; }
// the warps' sums of `nt` tiles' 2R x 8 values each, `parities` sets
template <int R>
__host__ __device__ constexpr size_t wide_red_bytes(int nt, int parities) {
  return sizeof(float) * (size_t)parities * nt * 2 * R * kLanes * kFlowWarps;
}

// shared memory of a wide launch: the mbarriers, the warps' sums, the
// warps' staged y, `slots` ring slots of `rows` input rows of `nt` tiles
template <int R, Storage S>
__host__ __device__ constexpr size_t wide_smem_bytes(int nt, int parities, int rows, int slots) {
  return flow_bar_bytes(slots) + wide_red_bytes<R>(nt, parities) +
         sizeof(float) * kFlowWarps * y_stage_floats<R>() +
         (size_t)slots * nt * flow_slot_bytes<S>(rows);
}

// The chunk rows and slots of a wide launch: the largest chunk (a multiple of
// 16 rows, of 128 in int8) whose ring takes 6 slots, else the largest that
// takes 2, with as many slots as fit; false where none does
template <int R, Storage S>
inline bool wide_ring(int nt, int parities, size_t optin, int& rows, int& slots) {
  constexpr int kRows[6] = {S == Storage::kInt8 ? 1024 : 512, S == Storage::kInt8 ? 512 : 256,
                           S == Storage::kInt8 ? 256 : 128, S == Storage::kInt8 ? 128 : 64, 32,
                           16};
  constexpr int kCount = S == Storage::kInt8 ? 4 : 6;
  for (int want = 6; want >= 2; want -= 4) {
    for (int k = 0; k < kCount; ++k) {
      int fit = 0;
      while (fit < kMaxSlots && wide_smem_bytes<R, S>(nt, parities, kRows[k], fit + 1) <= optin)
        ++fit;
      if (fit >= want) {
        rows = kRows[k];
        slots = fit;
        return true;
      }
    }
  }
  return false;
}

// The pivot ring of a wide launch: slot i at ring + i slot_bytes holds the
// chunk's rows of tile j at + j tile_bytes (real part, imaginary part at
// + im_off, int8 scales at + 2 im_off)
struct WideRing {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  size_t slot_bytes, tile_bytes;
  int im_off, rows, slots;
};

// 16 bytes global -> shared, of which the first `bytes` (16 or 0) are read
// and the rest zero-filled
__device__ __forceinline__ void cp_async16_fill(void* smem_dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(thomas::smem_addr(smem_dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kYDepth - 1) : "memory");
}

// One k-step of this warp on NT tiles of a ring slot: the B fragments of
// every tile first, then the products, so that the tiles' chains of
// products overlap; int8 partials times their block's scales
template <int R, Storage S, int NT>
__device__ __forceinline__ void wide_kstep(const unsigned (&a)[3][4], const unsigned char* slot,
                                           const WideRing& wr, int krow, bool half,
                                           float (&z1)[max_tiles<R>()][4],
                                           float (&z2)[max_tiles<R>()][4]) {
  constexpr int kQ = R == 8 ? 4 : 2;      // sums a lane keeps of a tile and part
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned b[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const unsigned char* run = slot + (size_t)j * wr.tile_bytes;
    if constexpr (S == Storage::kBf16) {
      wide::ldsm_b_bf16(run, wr.im_off, krow, lane, b[j]);
      if (half) b[j][1] = b[j][3] = 0u;      // rows 8..15 lie past the plane
    } else {
      wide::lds_b_int8(run, wr.im_off, krow, g, t, b[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float e1[4], e2[4];
    wide::plane_kstep<R>(a, b[j], e1, e2);
    if constexpr (S == Storage::kInt8) {
      // the k-step lies in one 128-row block: its scales of output lanes 2t,
      // 2t + 1 ([part][lane] floats)
      const float* sb = reinterpret_cast<const float*>(slot + (size_t)j * wr.tile_bytes +
                                                       2 * wr.im_off) +
                        krow / kScaleBlock * 2 * kLanes;
      const float2 sr = *reinterpret_cast<const float2*>(sb + 2 * t);
      const float2 si = *reinterpret_cast<const float2*>(sb + kLanes + 2 * t);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        z1[j][q] = fmaf(q & 1 ? sr.y : sr.x, e1[q], z1[j][q]);
        z2[j][q] = fmaf(q & 1 ? si.y : si.x, e2[q], z2[j][q]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        z1[j][q] += e1[q];
        z2[j][q] += e2[q];
      }
    }
  }
}

// This warp's products of one plane (a flow step, or an apply) on NT tiles:
// its k-steps u = warp, warp + 8, ... of the ld input rows, k-step u's 2R x
// 16 columns of y (rows at ysrc + rr ld, global memory) staged into ystage
// (cp.async, kYDepth - 1 k-steps ahead), split once and multiplied into the
// chunks' NT tiles; the plane's chunks are ring chunks g0 .. g0 + nch - 1,
// every one waited on and released by every warp.  z1[j], z2[j]: tile j's
// sums (wide::plane_kstep; R = 4 keeps two of the four).
template <int R, Storage S, int NT>
__device__ __forceinline__ void wide_products_nt(const WideRing& wr, int g0, int ld,
                                                 const float* ysrc, float* ystage,
                                                 float (&z1)[max_tiles<R>()][4],
                                                 float (&z2)[max_tiles<R>()][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int ksteps = (ld + 15) / 16, nch = (ld + wr.rows - 1) / wr.rows;

  // k-step i of this warp into stage slot i % kYDepth: 2R rows x 4 copies of
  // 16 bytes, those past ld zero-filled (no byte read)
  auto stage = [&](int i) {
    const int u = warp + kFlowWarps * i;
    if (u < ksteps && !kNoStage) {
      const int kb = 16 * u;
      float* dst = ystage + (i % kYDepth) * 2 * R * wide::kYPitch;
      for (int c = lane; c < 2 * R * 4; c += 32) {
        const int row = c >> 2, col = 4 * (c & 3);
        const bool in = kb + col < ld;
        cp_async16_fill(dst + row * wide::kYPitch + col,
                        in ? ysrc + (size_t)row * ld + kb + col : ysrc, in ? 16u : 0u);
      }
    }
    thomas::cp_async_commit();
  };
  // the ring chunks this warp holds: it waits on chunk `held` + 1 in slot
  // `next` with parity `par`; chunk `held` lies in slot `slot`
  int held = -1, slot = 0, next = g0 % wr.slots;
  unsigned par = (unsigned)(g0 / wr.slots) & 1u;
  auto hold = [&](int c) {
    for (; held < c; ++held) {
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(wr.empty + slot);
      }
      wait_phase<true>(wr.full + next, par);
      slot = next;
      if (++next == wr.slots) {
        next = 0;
        par ^= 1u;
      }
    }
  };

  int c = 0, crow = 0;      // the chunk of the k-step and its first row
  for (int i = 0; i < kYDepth - 1; ++i) stage(i);
  for (int i = 0;; ++i) {
    const int u = warp + kFlowWarps * i;
    if (u >= ksteps) break;
    __syncwarp();                       // every lane is done with slot (i - 1) % kYDepth
    stage(i + kYDepth - 1);
    cp_async_wait_ahead();
    __syncwarp();                       // k-step i's columns have landed, every lane's
    const int kb = 16 * u;
    for (; kb >= crow + wr.rows; crow += wr.rows) ++c;
    hold(c);
    if (kNoProducts) continue;
    unsigned a[3][4];
    wide::plane_a_frags<R>(ystage + (i % kYDepth) * 2 * R * wide::kYPitch, g, t, a);
    wide_kstep<R, S, NT>(a, wr.ring + (size_t)slot * wr.slot_bytes, wr, kb - crow, kb + 16 > ld,
                         z1, z2);
  }
  hold(nch - 1);
  __syncwarp();
  if (lane == 0) mbar_arrive(wr.empty + slot);
}

// wide_products_nt for the nt (1 .. max_tiles) tiles of this CTA or block
template <int R, Storage S, int NT = 1>
__device__ __forceinline__ void wide_products(const WideRing& wr, int g0, int ld, int nt,
                                              const float* ysrc, float* ystage,
                                              float (&z1)[max_tiles<R>()][4],
                                              float (&z2)[max_tiles<R>()][4]) {
  if constexpr (NT == 1) {
#pragma unroll
    for (int j = 0; j < max_tiles<R>(); ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) z1[j][q] = z2[j][q] = 0.f;
  }
  if constexpr (NT < max_tiles<R>()) {
    if (nt > NT) {
      wide_products<R, S, NT + 1>(wr, g0, ld, nt, ysrc, ystage, z1, z2);
      return;
    }
  }
  wide_products_nt<R, S, NT>(wr, g0, ld, ysrc, ystage, z1, z2);
}

// The producer warp's chunks of one plane (ring chunks g .. g + nch - 1):
// rows row0 .. of the nt tiles tile .. tile + nt - 1 of the stack
template <Storage S>
__device__ __forceinline__ void wide_produce(const WideRing& wr, int& g, const unsigned char* pre,
                                             const unsigned char* pim, const float* scale,
                                             size_t tile, int nt, int ld) {
  using St = Store<S>;
  for (int row0 = 0; row0 < ld; row0 += wr.rows, ++g) {
    const int sl = g % wr.slots;
    if (g >= wr.slots) wait_phase<false>(wr.empty + sl, (unsigned)(g / wr.slots - 1) & 1u);
    const int rows = min(wr.rows, ld - row0);
    const unsigned pb = (unsigned)rows * St::kRowBytes;
    const unsigned sb =
        S == Storage::kInt8 ? (unsigned)(rows / kScaleBlock * 2 * kLanes * sizeof(float)) : 0u;
    thomas::mbar_expect_tx(wr.full + sl, kNoStream ? 0u : (unsigned)nt * (2 * pb + sb));
    if (kNoStream) continue;
    for (int j = 0; j < nt; ++j) {
      unsigned char* dst = wr.ring + (size_t)sl * wr.slot_bytes + (size_t)j * wr.tile_bytes;
      const size_t off = ((tile + j) * ld + row0) * St::kRowBytes;
      thomas::bulk_copy(dst, pre + off, pb, wr.full + sl);
      thomas::bulk_copy(dst + wr.im_off, pim + off, pb, wr.full + sl);
      if (S == Storage::kInt8)
        thomas::bulk_copy(dst + 2 * wr.im_off,
                          scale + ((tile + j) * (ld / kScaleBlock) + row0 / kScaleBlock) * 2 * kLanes,
                          sb, wr.full + sl);
    }
  }
}

// Lays out the shared memory of a wide launch (nt_max tiles a CTA or block)
// and initialises the mbarriers; returns the ring, the warps' sums and the
// staged y of all warps
template <int R, Storage S>
__device__ __forceinline__ WideRing wide_layout(unsigned char* smem, int nt_max, int parities,
                                                int rows, int slots, float*& red,
                                                float*& ystage) {
  WideRing wr;
  wr.full = reinterpret_cast<uint64_t*>(smem);
  wr.empty = wr.full + slots;
  red = reinterpret_cast<float*>(smem + flow_bar_bytes(slots));
  ystage = red + wide_red_bytes<R>(nt_max, parities) / sizeof(float);
  wr.ring = reinterpret_cast<unsigned char*>(ystage + kFlowWarps * y_stage_floats<R>());
  wr.tile_bytes = flow_slot_bytes<S>(rows);
  wr.slot_bytes = (size_t)nt_max * wr.tile_bytes;
  wr.im_off = rows * Store<S>::kRowBytes;
  wr.rows = rows;
  wr.slots = slots;
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      thomas::mbar_init(wr.full + i, 1);
      thomas::mbar_init(wr.empty + i, kFlowWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return wr;
}

// The warps' sums of nt tiles (part [j][value][warp]) added in warp order by
// the consumer threads: value v of tile j goes to emit(j, v, sum)
template <int R, typename Emit>
__device__ __forceinline__ void wide_reduce(const float* part, int nt, Emit emit) {
  constexpr int V = 2 * R * kLanes;
  for (int i = threadIdx.x; i < nt * V; i += kFlowConsumers) {
    const float4* sums = reinterpret_cast<const float4*>(part + (size_t)i * kFlowWarps);
    float v = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < kFlowWarps / 4; ++c4) {
      const float4 f4 = sums[c4];
      v += f4.x;
      v += f4.y;
      v += f4.z;
      v += f4.w;
    }
    emit(i / V, i % V, v);
  }
}

// This warp's sums of its nt tiles into part[j][value][warp]
template <int R>
__device__ __forceinline__ void wide_store_parts(const float (&z1)[max_tiles<R>()][4],
                                                 const float (&z2)[max_tiles<R>()][4], int nt,
                                                 float* part) {
  constexpr int V = 2 * R * kLanes;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < max_tiles<R>(); ++j)
    if (j < nt) wide::plane_store_part<R>(z1[j], z2[j], part + ((size_t)j * V) * kFlowWarps + warp,
                                          kFlowWarps);
}

// the flag half of an exchange word, by an acquire load
__device__ __forceinline__ unsigned ld_flag_acquire(const uint2* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(reinterpret_cast<const unsigned*>(p) + 1)
               : "memory");
  return v;
}

// waits until the words[0 .. n) (n <= 160) all carry `flag`: lane l polls
// words l, l + 32, ... together, again for those not yet there; a wait
// longer than any step takes traps
__device__ __forceinline__ void wait_flags(const uint2* words, int n, unsigned flag) {
  constexpr int kPer = 5;
  const int lane = threadIdx.x & 31;
  bool ready[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) ready[k] = lane + 32 * k >= n;
  for (unsigned polls = 0;; ++polls) {
    unsigned got[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) got[k] = ready[k] ? flag : ld_flag_acquire(words + lane + 32 * k);
    bool all = true;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      ready[k] = got[k] == flag;
      all = all && ready[k];
    }
    if (all) return;
    if (polls > (1u << 24)) __trap();
  }
}

// The flag-handoff step at r = 4 and 8 (note 4).  Exchange words: slot s & 1
// of the y words holds the CTAs' flags of step s (word c: CTA c has written
// its lanes of y_s), the t words as in flow_narrow.  y_s itself: the y stack
// (forward) or the two-plane scratch in a.kept (backward, plane s & 1).
template <int R, bool kBackward, Storage S>
__device__ __forceinline__ void flow_wide(const FlowArgs& fa) {
  constexpr int V = 2 * R * kLanes;
  constexpr int NW = 2 * R;
  constexpr int kMT = max_tiles<R>();
  const PassArgs& a = fa.a;
  const int ld = a.ld, mn = a.mn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int count = a.l - a.start;
  const size_t row = (size_t)2 * R * ld;
  const int tiles_row = ld / kLanes;
  const int G = (int)gridDim.x, c = (int)blockIdx.x;
  const int nt = tiles_row / G + (c < tiles_row % G);
  const int nt_max = (tiles_row + G - 1) / G;
  const int tile0 = c * (tiles_row / G) + min(c, tiles_row % G);
  const int f0 = tile0 * kLanes, nf = nt * kLanes;
  const int nch = (ld + fa.rows - 1) / fa.rows;

  extern __shared__ __align__(128) unsigned char smem[];
  float *red, *ystage;
  const WideRing wr = wide_layout<R, S>(smem, nt_max, 2, fa.rows, fa.slots, red, ystage);
  auto plane_of = [&](int s) { return kBackward ? a.l - 1 - s : a.start + s; };

  if (warp == kFlowWarps) {
    if (lane == 0) {
      int g = 0;
      for (int s = 0; s < count; ++s)
        wide_produce<S>(wr, g, static_cast<const unsigned char*>(a.pre),
                        static_cast<const unsigned char*>(a.pim), a.scale,
                        (size_t)(a.base + plane_of(s)) * tiles_row + tile0, nt, ld);
    }
    return;
  }

  int offs[kTaps];
#pragma unroll
  for (int d = 0; d < kTaps; ++d) offs[d] = (d / 3 - 1) * a.n + (d % 3 - 1);
  auto cta_flags = [&](int s) { return fa.xchg + (size_t)(s & 1) * ld * NW; };
  auto t_words = [&](int s) { return fa.xchg + (size_t)(kWordSlots + (s & 1)) * ld * NW; };
  auto y_rows = [&](int s) {
    return a.kept + (kBackward ? (size_t)(s & 1) * row : (size_t)plane_of(s) * row);
  };

  // (a) runs a thread per lane and pair of right-hand sides: lane f0 + li,
  // rows cp, cp + 1 (re) and R + cp, R + cp + 1 (im)
  const bool former = tid < nf * (R / 2);
  const int li = former ? tid % nf : 0, cp = former ? 2 * (tid / nf) : 0;
  const int f = f0 + li;
  const bool my_lane = former && f < mn;
  float rb[4], wre[kTaps], wim[kTaps];
  auto prefetch = [&](int s) {
    if (!my_lane || s >= count) return;
    const int p = plane_of(s);
    const float* rhs = a.rhs + (size_t)p * row;
    const float* w = a.w + (size_t)p * 2 * kTaps * ld;
#pragma unroll
    for (int e = 0; e < 4; ++e) rb[e] = __ldg(rhs + (e < 2 ? cp + e : R + cp + e - 2) * ld + f);
#pragma unroll
    for (int d = 0; d < kTaps; ++d) {
      wre[d] = __ldg(w + d * ld + f);
      wim[d] = __ldg(w + (kTaps + d) * ld + f);
    }
  };
  prefetch(0);

  float* my_stage = ystage + warp * y_stage_floats<R>();
  int g = 0;
  for (int s = 0; s < count; ++s) {
    const int p = plane_of(s);
    const unsigned flag = fa.epoch + (unsigned)s;
    float* ys = y_rows(s);

    // (a) this CTA's lanes of y_s, written as plain rows; then its flag
    if (former) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = my_lane ? rb[e] : 0.f;
      const bool from_init = s == 0 && !kBackward && a.t_init != nullptr;
      if (my_lane && (s > 0 || from_init) && !kNoStencil) {
        float cv[kTaps][4];
        if (from_init) {
          // once a launch: a loop, not unrolled, keeps the registers free
          // for the polls of every later step
#pragma unroll 1
          for (int d = 0; d < kTaps; ++d) {
            const int src = f + offs[d];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rr = e < 2 ? cp + e : R + cp + e - 2;
              cv[d][e] = src >= 0 && src < mn ? __ldg(a.t_init + rr * ld + src) : 0.f;
            }
          }
        } else {
          const uint2* tw = t_words(s - 1);
          const uint2* ptr[2 * kTaps];
#pragma unroll
          for (int d = 0; d < kTaps; ++d) {
            const int src = f + offs[d];
            const bool in = src >= 0 && src < mn;
            ptr[2 * d] = in ? tw + ((size_t)src * NW + cp) : nullptr;
            ptr[2 * d + 1] = in ? tw + ((size_t)src * NW + R + cp) : nullptr;
          }
          uint4 v[2 * kTaps];
          thomas::poll_words<2 * kTaps, !kNoSync>(ptr, v, flag - 1u);
#pragma unroll
          for (int d = 0; d < kTaps; ++d) {
            const bool in = ptr[2 * d] != nullptr;
            cv[d][0] = in ? __uint_as_float(v[2 * d].x) : 0.f;
            cv[d][1] = in ? __uint_as_float(v[2 * d].z) : 0.f;
            cv[d][2] = in ? __uint_as_float(v[2 * d + 1].x) : 0.f;
            cv[d][3] = in ? __uint_as_float(v[2 * d + 1].z) : 0.f;
          }
        }
        float accr[2] = {0.f, 0.f}, acci[2] = {0.f, 0.f};
#pragma unroll
        for (int d = 0; d < kTaps; ++d) {
          const int src = f + offs[d];
          if (src < 0 || src >= mn) continue;      // zero weight: never read
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float tr = cv[d][e], ti = cv[d][2 + e];
            accr[e] = accr[e] + wre[d] * tr - wim[d] * ti;
            acci[e] = acci[e] + wre[d] * ti + wim[d] * tr;
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] -= accr[e];
          y[2 + e] -= acci[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ys[(e < 2 ? cp + e : R + cp + e - 2) * ld + f] = y[e];
    }
    // the CTA's rows, ordered by the barrier, before its flag (a fence by one
    // thread, as a grid barrier publishes its arrivals)
    consumer_sync();
    if (tid == 0) {
      __threadfence();
      thomas::st_word(cta_flags(s) + c, 0.f, flag);
    }
    prefetch(s + 1);

    // (b) every CTA's flag of step s (the one grid-wide wait: a warp's lanes
    //     poll them at once, with acquire loads), then the rows
    if (!kNoSync && !kNoStage) wait_flags(cta_flags(s), G, flag);
    __syncwarp();

    // (c) the products, the warps' sums, the tiles published
    float z1[kMT][4], z2[kMT][4];
    wide_products<R, S>(wr, g, ld, nt, ys, my_stage, z1, z2);
    g += nch;
    float* part = red + (size_t)(s & 1) * nt_max * V * kFlowWarps;
    wide_store_parts<R>(z1, z2, nt, part);
    consumer_sync();
    float* t_out = a.out != nullptr ? a.out + (size_t)p * row : nullptr;
    wide_reduce<R>(part, nt, [&](int j, int vi, float v) {
      const int rr = vi / kLanes, o = (tile0 + j) * kLanes + vi % kLanes;
      if (t_out != nullptr) t_out[rr * ld + o] = v;
      thomas::st_word(t_words(s) + (size_t)o * NW + rr, v, flag);
    });
  }
}

template <int R, bool kBackward, Storage S>
__global__ void __launch_bounds__(kFlowThreads, 1) flow_kernel(const FlowArgs fa) {
  if constexpr (wide<R>())
    flow_wide<R, kBackward, S>(fa);
  else
    flow_narrow<R, kBackward, S>(fa);
}

// Launches a pass on the flag-handoff step: a cooperative launch of one CTA
// an SM (none without a tile)
template <int R, bool kBackward, Storage S>
inline cudaError_t launch_flow(const PassArgs& a, uint2* xchg, unsigned epoch,
                               cudaStream_t stream) {
  auto kernel = flow_kernel<R, kBackward, S>;
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // whole tiles, ceil(tiles / CTAs) at most a CTA
  const int tiles = a.ld / kLanes;
  const int grid = tiles < sms ? tiles : sms;
  const int nt_max = (tiles + grid - 1) / grid;
  FlowArgs fa{a, xchg, epoch, 0, 0};
  size_t smem = 0;
  if constexpr (wide<R>()) {
    // at most max_tiles tiles a CTA, whose lanes' y (a thread per lane and
    // pair of right-hand sides) its consumer threads form
    if (nt_max > max_tiles<R>() || nt_max * kLanes * (R / 2) > kFlowConsumers || grid > 160 ||
        !wide_ring<R, S>(nt_max, 2, (size_t)optin, fa.rows, fa.slots))
      return cudaErrorInvalidValue;                          // plane too wide
    smem = wide_smem_bytes<R, S>(nt_max, 2, fa.rows, fa.slots);
  } else {
    if (!flow_ring<R, S>(a.ld, (size_t)optin, fa.rows, fa.slots))
      return cudaErrorInvalidValue;                          // plane too wide
    smem = flow_smem_bytes<R, S>(a.ld, fa.rows, fa.slots);
    // a CTA forms the y of at most kFlowConsumers lanes (32 tiles)
    if (nt_max * kLanes > kFlowConsumers) return cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFlowThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  void* params[] = {&fa};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kFlowThreads), params, smem,
                                     stream);
}

// the storage is int8 when scales are given (ld a multiple of 128), else
// bf16 (ld a multiple of 8)
inline bool valid(int mn, int ld, int r, const float* scale) {
  const int mult = scale != nullptr ? kScaleBlock : kLanes;
  return mn >= 1 && ld >= mn && ld % mult == 0 && launch_width(r);
}

inline bool valid_pass(int r, const PassArgs& a) {
  return valid(a.mn, a.ld, r, a.scale) && a.l >= 1 && a.n >= 1 && a.base >= 0 && a.start >= 0 &&
         a.start < a.l && (a.kept != nullptr || a.out != nullptr);
}

template <bool kBackward, Storage S>
inline cudaError_t launch_flow_r(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                                 cudaStream_t stream) {
  switch (r) {
    case 1: return launch_flow<1, kBackward, S>(a, xchg, epoch, stream);
    case 2: return launch_flow<2, kBackward, S>(a, xchg, epoch, stream);
    case 4: return launch_flow<4, kBackward, S>(a, xchg, epoch, stream);
    case 8: return launch_flow<8, kBackward, S>(a, xchg, epoch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// A pass on the flag-handoff step: forward (y stack in `kept`) or backward
template <bool kBackward>
inline cudaError_t run_flow(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                            cudaStream_t stream) {
  const unsigned steps = (unsigned)(a.l - a.start);
  // the forward pass writes its y stack; the backward pass needs a scratch for
  // its planes' rows at r = 4 and 8 (note 4)
  if (!valid_pass(r, a) || (a.kept == nullptr && (!kBackward || r > 2)) ||
      (kBackward && a.out == nullptr) ||
      xchg == nullptr || epoch == 0u || epoch + steps < epoch)
    return cudaErrorInvalidValue;
  if (a.scale != nullptr) return launch_flow_r<kBackward, Storage::kInt8>(r, a, xchg, epoch, stream);
  return launch_flow_r<kBackward, Storage::kBf16>(r, a, xchg, epoch, stream);
}

// One plane apply: block t computes output tile t of [Yr; Yi] @ P[idx], rows
// read from global memory as the chunks stream (no bound on ld).
template <int R, Storage S>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const float* rows, const void* pre, const void* pim, const float* scale,
                 float* out, int ld, int idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileStream<S> ts;
  ts.pre = static_cast<const unsigned char*>(pre);
  ts.pim = static_cast<const unsigned char*>(pim);
  ts.scale = scale;
  ts.ring = smem_raw;
  ts.ld = ld;
  ts.tiles_row = ld / kLanes;
  ts.nch = (ld + Store<S>::kChunkRows - 1) / Store<S>::kChunkRows;
  ts.total = ts.nch;
  ts.first = idx;
  ts.dir = 0;
  ts.tiles_blk = 1;
  float* red = reinterpret_cast<float*>(smem_raw + Store<S>::kRingBytes);
  for (int g = 0; g < kStages - 1; ++g) ts.request(g);
  int g = 0;
  tile_product<R, S>(ts, g, rows, red, out, (int)blockIdx.x * kLanes);
}

struct ApplyArgs {
  const float* rows;       // (2r, ld)
  const void* pre;         // planes, as PassArgs
  const void* pim;
  const float* scale;
  float* out;              // (2r, ld)
  int ld, idx;
  int rows_c, slots;       // ring chunk rows and slots
};

// One plane apply at r = 4 and 8 (note 4): block b owns the consecutive
// tiles b per .. of the plane (per = ceil(tiles / blocks)), 8 consumer warps
// multiply the rows, read from global memory a k-step at a time, into all of
// them as the producer warp streams their chunks
template <int R, Storage S>
__global__ void __launch_bounds__(kFlowThreads, 1) apply_kernel(const ApplyArgs aa) {
  const int ld = aa.ld, tiles = ld / kLanes;
  const int per = (tiles + (int)gridDim.x - 1) / (int)gridDim.x;
  const int tile0 = (int)blockIdx.x * per, nt = min(per, tiles - tile0);
  if (nt <= 0) return;
  extern __shared__ __align__(128) unsigned char smem[];
  float *red, *ystage;
  const WideRing wr = wide_layout<R, S>(smem, per, 1, aa.rows_c, aa.slots, red, ystage);
  const int warp = threadIdx.x >> 5;
  if (warp == kFlowWarps) {
    int g = 0;
    if ((threadIdx.x & 31) == 0)
      wide_produce<S>(wr, g, static_cast<const unsigned char*>(aa.pre),
                      static_cast<const unsigned char*>(aa.pim), aa.scale,
                      (size_t)aa.idx * tiles + tile0, nt, ld);
    return;
  }
  float z1[max_tiles<R>()][4], z2[max_tiles<R>()][4];
  wide_products<R, S>(wr, 0, ld, nt, aa.rows, ystage + warp * y_stage_floats<R>(), z1, z2);
  wide_store_parts<R>(z1, z2, nt, red);
  consumer_sync();
  wide_reduce<R>(red, nt, [&](int j, int vi, float v) {
    aa.out[(vi / kLanes) * ld + (tile0 + j) * kLanes + vi % kLanes] = v;
  });
}

template <int R, Storage S>
inline cudaError_t launch_apply(const float* rows, const void* pre, const void* pim,
                                const float* scale, float* out, int ld, int idx,
                                cudaStream_t stream) {
  if constexpr (wide<R>()) {
    // one wave of blocks of at most max_tiles tiles
    void (*kernel)(const ApplyArgs) = apply_kernel<R, S>;
    int dev = 0, sms = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int tiles = ld / kLanes;
    const int ceil_tiles = (tiles + sms - 1) / sms;
    const int want = ceil_tiles < max_tiles<R>() ? ceil_tiles : max_tiles<R>();
    const int grid = (tiles + want - 1) / want, per = (tiles + grid - 1) / grid;
    ApplyArgs aa{rows, pre, pim, scale, out, ld, idx, 0, 0};
    if (!wide_ring<R, S>(per, 1, (size_t)optin, aa.rows_c, aa.slots)) return cudaErrorInvalidValue;
    const size_t smem = wide_smem_bytes<R, S>(per, 1, aa.rows_c, aa.slots);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kFlowThreads, smem, stream>>>(aa);
  } else {
    const size_t smem = Store<S>::kRingBytes + red_bytes<R>();
    apply_kernel<R, S><<<ld / kLanes, kThreads, smem, stream>>>(rows, pre, pim, scale, out, ld,
                                                               idx);
  }
  return cudaGetLastError();
}

template <Storage S>
inline cudaError_t launch_apply_r(int r, const float* rows, const void* pre, const void* pim,
                                  const float* scale, float* out, int ld, int idx,
                                  cudaStream_t stream) {
  switch (r) {
    case 1: return launch_apply<1, S>(rows, pre, pim, scale, out, ld, idx, stream);
    case 2: return launch_apply<2, S>(rows, pre, pim, scale, out, ld, idx, stream);
    case 4: return launch_apply<4, S>(rows, pre, pim, scale, out, ld, idx, stream);
    case 8: return launch_apply<8, S>(rows, pre, pim, scale, out, ld, idx, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace plane
