// Plane-pivot substitution for the 3D block-Thomas solves: the body of the
// three plane kernels
//
//     plane::pass_kernel<R, false, S>   forward pass over a slab's planes   plane_fwd.cu
//     plane::pass_kernel<R, true, S>    backward pass                       plane_bwd.cu
//     plane::apply_kernel<R, S>         one plane apply [Yr; Yi] @ P[k]     plane_apply.cu
//
// which those files instantiate and launch, for S = Storage::kBf16 (bf16
// pivot planes) and S = Storage::kInt8 (int8 planes with f32 scales).  A 3D
// stencil matrix on an (l, a, b) grid is block tridiagonal over its z-planes:
// the pivot blocks are dense (mn x mn) inverses, mn = a b, and the couplings
// between planes are 9-tap in-plane stencils.  Per plane p (forward:
// start..l-1, backward: l-1..start) a pass computes
//
//     y_p = rhs_p - S_p(carry)            9-tap complex stencil, flat shifts
//     t_p = y_p . P[base + p]             [Yr; Yi] @ P, bf16 or int8 plane
//
// where carry is the t of the plane before (forward: p-1, backward: p+1).
// The forward pass takes its first carry from the caller (t_init, zero when
// absent) and keeps the y stack (for the backward pass) and, when asked, the
// t stack, which is then also where the carry lives; otherwise the carry
// lives in a one-plane scratch.  The backward pass keeps its x stack, which
// is its carry too, and holds y_p - S'_p(x_{p+1}) in a one-plane scratch.
// One plane of scratch is enough for either: between the phase that reads a
// plane's carry and the phase that overwrites it there is a grid barrier.
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
// scale 1, and padding lanes are never read as sources (design note 3).
//
// Design.
//
// 1. The stencil is 9 taps wide and the whole y_p feeds every output tile.
//    The 2D body (thomas_line.cuh) lets every block recompute w from a 3-tap
//    band that it stages; here one plane's weight rows are 2 x 9 x ld x 4 B
//    (166 KB at mn = 2304), so every block holding its own copy would read as
//    many bytes from L2 as the plane itself.  Instead a plane step has two
//    phases: (A) the threads of the whole grid share out the lanes of y_p,
//    each forming its lanes from the carry in global memory and its own
//    weights, and write them to the y stack (an output anyway; the scratch in
//    the backward pass); then, after a grid barrier, (B) every block loads
//    the whole y_p (2r x ld floats, from L2) into shared memory and computes
//    its output tiles of t_p.  A second barrier ends the step.  The whole
//    pass is ONE COOPERATIVE LAUNCH whose blocks stay resident and meet at
//    cooperative_groups::this_grid().sync(); the grid is sized from the
//    occupancy query, so a launch that does not fit is refused, it does not
//    hang.
//
// 2. Shared memory does not grow with the plane's width: a tile's pivot
//    columns stream through a ring of kStages chunks of kChunkBytes per plane
//    (256 input rows in bf16, 512 in int8, with the int8 chunk's 4 x 2 x 8
//    scales beside it), filled with cp.async kStages - 1 chunks ahead.  The
//    ring runs on across tiles, planes and barriers: the columns of the next
//    tile do not depend on the carry, so they are in flight while the block
//    waits at the barriers.  What grows with mn is the staged y_p (2r x ld
//    floats), which bounds the fused passes to ld <= 12448 at r = 2 (24928 at
//    r = 1) in bf16 on an H100; the plane apply reads its rows from global
//    memory and has no such bound (the wrappers send larger stacks to the
//    per-plane path).
//
// 3. Flat shifts never read outside the plane.  The TPU kernel rolls lanes
//    around the padded row and relies on the packed weights being exact zeros
//    wherever a tap leaves the plane; here a source index outside [0, mn) is
//    skipped (it has a zero weight), so padding lanes are never read and a
//    non-finite value there cannot leak in.
//
// 4. int8 widening.  A thread takes one input row (8 lanes, 8 bytes) of each
//    plane at a time; with 128 threads and chunks of 4 x 128 rows, pass j of
//    a chunk lies in scale block j for every thread, so the 2 x 8 scales of a
//    pass are one broadcast read of shared memory.  The bytes become floats
//    without a conversion instruction (the card converts 16 values per clock
//    and SM, fewer than the plane's bytes arrive): q ^ 0x80 is q + 128 as an
//    unsigned byte, one byte-permute puts it into the mantissa of 2^23, and
//    one subtraction of 2^23 + 128 leaves q exactly.
//
// Bound: bytes.  A plane step must read the two planes once: 2 x ld^2 x 2 B
// in bf16 (21.2 MB at mn = 2304, 6.3 us at the card's 3.35 TB/s), 2 x ld^2 B
// plus 2 x ld^2 / 128 x 4 B of scales in int8 (19.5 MB at ld = 3072, 5.8 us);
// the weight rows and the row stacks add about 1 %.  The arithmetic is
// 2 x 2r x 2 x ld^2 flop, far below the f32 rate; int8 adds a widening and a
// scaling per element (about 3 ld^2 more operations at r = 1), which stays
// below it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace plane {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;          // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;              // output lanes per tile
constexpr int kChunkBytes = 4096;      // bytes of one plane's tile per staged chunk
constexpr int kStages = 4;             // chunks in the ring
constexpr int kMaxRhs = 2;             // right-hand sides per launch
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
#ifndef PLANE_ABLATE
#define PLANE_ABLATE 0
#endif
constexpr bool kNoBarrier = PLANE_ABLATE & 1;    // neither grid barrier
constexpr bool kNoStencil = PLANE_ABLATE & 2;    // no stencil phase (A)
constexpr bool kNoStream = PLANE_ABLATE & 4;     // no pivot columns: no loads, no products

template <int R>
__host__ __device__ constexpr size_t red_bytes() {
  return sizeof(float) * kWarps * 2 * R * kLanes;
}

// shared memory of a fused pass: the ring, the staged y_p, the reduction
template <int R, Storage S>
__host__ __device__ constexpr size_t pass_smem_bytes(int ld) {
  return Store<S>::kRingBytes + sizeof(float) * (size_t)2 * R * ld + red_bytes<R>();
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
// leaves q exactly (design note 4)
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

// The block's stream of pivot-tile chunks.  Work item q is output tile
// blockIdx.x + k gridDim.x of plane first + dir (q / tiles_blk), k = q %
// tiles_blk; chunk c of an item covers input rows [c kChunkRows, (c+1)
// kChunkRows).  Chunk g = q nch + c goes to ring slot g % kStages.
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

// One input row's 8 lanes of both planes as floats: bf16 row i of the chunk,
// or int8 row i (scale block i / 128) dequantized element by element
template <Storage S>
__device__ __forceinline__ void load_row(const unsigned char* sre, int i, float* cr,
                                         float* ci) {
  const unsigned char* sim = sre + kChunkBytes;
  if (S == Storage::kBf16) {
    widen_bf16x8(reinterpret_cast<const uint4*>(sre)[i], cr);
    widen_bf16x8(reinterpret_cast<const uint4*>(sim)[i], ci);
  } else {
    const float* sc = reinterpret_cast<const float*>(sim + kChunkBytes) +
                      (i / kScaleBlock) * 2 * kLanes;
    widen_s8x8(reinterpret_cast<const uint2*>(sre)[i], cr);
    widen_s8x8(reinterpret_cast<const uint2*>(sim)[i], ci);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      cr[l] *= sc[l];
      ci[l] *= sc[kLanes + l];
    }
  }
}

// One output tile: stream its nch chunks (chunk counter g runs on), multiply
// by the rows y (2R x ld floats, shared or global memory), reduce over the
// block and write the 2R x 8 results to out[qq ld + o0 + l].
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
    const int row0 = c * St::kChunkRows;
    const int rows = kNoStream ? 0 : min(St::kChunkRows, ld - row0);
#pragma unroll 2
    for (int i = tid; i < rows; i += kThreads) {
      float cr[kLanes], ci[kLanes];
      load_row<S>(sre, i, cr, ci);
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
                           //   backward: one-plane scratch (2r, ld)
  float* out;              // t stack (forward; may be null) or x stack
                           //   (backward), (l, 2r, ld), planes >= start
  float* carry;            // forward without a t stack: one-plane scratch
                           //   (2r, ld); else unused
  int l, mn, n, ld;        // n: the plane's fast axis, for the flat shifts
  int base;                // pivot plane of plane p is base + p
  int start;               // planes start..l-1 are computed
};

// R = number of right-hand sides r (rows are 2R); kBackward = top-down pass;
// S = storage of the pivot planes.
template <int R, bool kBackward, Storage S>
__global__ void __launch_bounds__(kThreads) pass_kernel(const PassArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_y = reinterpret_cast<float*>(smem_raw + Store<S>::kRingBytes);   // [2R][ld]
  float* red = s_y + (size_t)2 * R * a.ld;                          // [kWarps][2R*8]

  const int tid = threadIdx.x;
  const int ld = a.ld, mn = a.mn;
  const size_t row = (size_t)2 * R * ld;         // floats per plane of a stack
  const int tiles_row = ld / kLanes;
  const int count = a.l - a.start;
  const int tiles_blk = (tiles_row - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  TileStream<S> ts;
  ts.pre = static_cast<const unsigned char*>(a.pre);
  ts.pim = static_cast<const unsigned char*>(a.pim);
  ts.scale = a.scale;
  ts.ring = smem_raw;
  ts.ld = ld;
  ts.tiles_row = tiles_row;
  ts.nch = (ld + Store<S>::kChunkRows - 1) / Store<S>::kChunkRows;
  ts.total = count * tiles_blk * ts.nch;
  ts.first = a.base + (kBackward ? a.l - 1 : a.start);
  ts.dir = kBackward ? -1 : 1;
  ts.tiles_blk = tiles_blk;
  for (int g = 0; g < kStages - 1; ++g) ts.request(g);
  int g = 0;

  // flat offsets of the taps: (dj, di) -> dj n + di
  int offs[kTaps];
#pragma unroll
  for (int d = 0; d < kTaps; ++d) offs[d] = (d / 3 - 1) * a.n + (d % 3 - 1);

  for (int s = 0; s < count; ++s) {
    const int p = kBackward ? a.l - 1 - s : a.start + s;
    const float* carry =
        kBackward ? (s == 0 ? nullptr : a.out + (size_t)(p + 1) * row)
                  : (s == 0 ? a.t_init : a.out ? a.out + (size_t)(p - 1) * row : a.carry);
    float* ydst = kBackward ? a.kept : a.kept + (size_t)p * row;
    float* t_out = kBackward || a.out ? a.out + (size_t)p * row : a.carry;

    // (A) y_p = rhs_p - S_p(carry), lanes shared out over the whole grid; the
    //     carry was written by other blocks: read it past the (incoherent) L1
    const float* rhs = a.rhs + (size_t)p * row;
    const float* w = a.w + (size_t)p * 2 * kTaps * ld;
    for (int f = blockIdx.x * kThreads + tid; f < (kNoStencil ? 0 : ld);
         f += gridDim.x * kThreads) {
      float accr[R], acci[R];
#pragma unroll
      for (int q = 0; q < R; ++q) accr[q] = acci[q] = 0.f;
      if (carry != nullptr && f < mn) {
#pragma unroll
        for (int d = 0; d < kTaps; ++d) {
          const int src = f + offs[d];
          if (src < 0 || src >= mn) continue;      // zero weight: never read
          const float wr = __ldg(w + d * ld + f);
          const float wi = __ldg(w + (kTaps + d) * ld + f);
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const float tr = __ldcg(carry + q * ld + src);
            const float ti = __ldcg(carry + (R + q) * ld + src);
            accr[q] = accr[q] + wr * tr - wi * ti;
            acci[q] = acci[q] + wr * ti + wi * tr;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        ydst[q * ld + f] = f < mn ? __ldg(rhs + q * ld + f) - accr[q] : 0.f;
        ydst[(R + q) * ld + f] = f < mn ? __ldg(rhs + (R + q) * ld + f) - acci[q] : 0.f;
      }
    }
    if (!kNoBarrier) cg::this_grid().sync();

    // (B) the whole y_p into shared memory, then this block's tiles of t_p
    for (int i = tid; i < 2 * R * ld / 4; i += kThreads)
      reinterpret_cast<float4*>(s_y)[i] = __ldcg(reinterpret_cast<const float4*>(ydst) + i);
    __syncthreads();
    for (int k = 0; k < tiles_blk; ++k)
      tile_product<R, S>(ts, g, s_y, red, t_out, ((int)blockIdx.x + k * (int)gridDim.x) * kLanes);

    // all tiles of t_p are complete before any block forms y_{p+1}
    if (s + 1 < count && !kNoBarrier) cg::this_grid().sync();
  }
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

// the storage is int8 when scales are given (ld a multiple of 128), else
// bf16 (ld a multiple of 8)
inline bool valid(int mn, int ld, int r, const float* scale) {
  const int mult = scale != nullptr ? kScaleBlock : kLanes;
  return mn >= 1 && ld >= mn && ld % mult == 0 && r >= 1 && r <= kMaxRhs;
}

template <int R, bool kBackward, Storage S>
inline cudaError_t launch_pass(const PassArgs& a, cudaStream_t stream) {
  auto kernel = pass_kernel<R, kBackward, S>;
  const size_t smem = pass_smem_bytes<R, S>(a.ld);
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;   // plane too wide
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const int tiles = a.ld / kLanes;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  PassArgs args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kThreads), params, smem,
                                     stream);
}

template <bool kBackward, Storage S>
inline cudaError_t launch_pass_r(int r, const PassArgs& a, cudaStream_t stream) {
  return r == 1 ? launch_pass<1, kBackward, S>(a, stream) : launch_pass<2, kBackward, S>(a, stream);
}

template <bool kBackward>
inline cudaError_t run_pass(int r, const PassArgs& a, cudaStream_t stream) {
  if (!valid(a.mn, a.ld, r, a.scale) || a.l < 1 || a.n < 1 || a.base < 0 || a.start < 0 ||
      a.start >= a.l || a.kept == nullptr || (a.out == nullptr && a.carry == nullptr))
    return cudaErrorInvalidValue;
  return a.scale != nullptr ? launch_pass_r<kBackward, Storage::kInt8>(r, a, stream)
                            : launch_pass_r<kBackward, Storage::kBf16>(r, a, stream);
}

template <int R, Storage S>
inline cudaError_t launch_apply(const float* rows, const void* pre, const void* pim,
                                const float* scale, float* out, int ld, int idx,
                                cudaStream_t stream) {
  const size_t smem = Store<S>::kRingBytes + red_bytes<R>();
  apply_kernel<R, S><<<ld / kLanes, kThreads, smem, stream>>>(rows, pre, pim, scale, out, ld,
                                                             idx);
  return cudaGetLastError();
}

template <Storage S>
inline cudaError_t launch_apply_r(int r, const float* rows, const void* pre, const void* pim,
                                  const float* scale, float* out, int ld, int idx,
                                  cudaStream_t stream) {
  return r == 1 ? launch_apply<1, S>(rows, pre, pim, scale, out, ld, idx, stream)
                : launch_apply<2, S>(rows, pre, pim, scale, out, ld, idx, stream);
}

}  // namespace plane
