// Block-Thomas line step: the grid-barrier step of the 2D substitution kernels
//
//     pass_kernel<R, true,  false, true>    backward pass on      thomas_bwd.cu
//                                           banded+tail pivots
//
// and, only in a build with -DTHOMAS_OLD_STEP=1 (benchmarks_torch/
// thomas_probe.py and thomas_ablation.py time old against new), the parent
// step of every other line kernel, which the package runs on the
// flag-handoff step of thomas_flow.cuh:
//
//     pass_kernel<R, false, false>          forward pass          thomas_fwd.cu
//     pass_kernel<R, true,  false>          backward pass         thomas_bwd.cu
//     pass_kernel<R, false, true>           cached forward pass   thomas_fwd_cached.cu
//     pass_kernel<R, false, true,  true>    the same, banded+tail thomas_fwd_cached.cu
//     pass_kernel<R, ..., false, kInt8>     the dense passes on int8 planes
//     sweep::down_kernel<R>, up_kernel<R>   whole Gauss-Seidel    sweep_fused.cu
//                                           sweep directions
//
// This note also holds what both steps share: the layouts, the numerics
// contract, the bound.  Every kernel is a walk over line steps; a kernel
// differs from the others only in the order of its steps and in where each
// step's operands come from and go to.  So the step is one device routine
// here, run_steps, and a kernel is a small "step map" that tells it, for each
// of a block's work items, where the operands are (a Tile).  Direction,
// caching, the pivot layout and the pivot storage (bf16, or int8 with f32
// scales) are template parameters, so that each kernel is a kernel of its own
// (and has its own name in a profiler's trace).
//
// Per line j and batch row b (slab s) a step computes
//
//     w = rhs_j [+- cpl . trace] - band_j . prev     complex 3-tap bands
//     t = C_j^{-1} w                                  [Wr; Wi] @ Cinv^T
//
// where prev is the carry (the t of the line before, or zero at a pass's
// first line, or a carry handed in) and the bracket is the sweep kernels'
// equivalent-source injection at a trace line.  Numerics contract of the JAX
// package's Pallas kernels (sparse/pallas_thomas.py: _band_apply_multi,
// _pivot_dot_multi; sparse/pallas_sweep.py: _inject): bf16 pivot planes
// widened to f32, f32 multiply-add and accumulation, f32 carries and bands,
// complex arithmetic as separate re/im rows stacked [re_0..re_{r-1};
// im_0..im_{r-1}].
//
// Work split within a line.  A tile is kLanes = 8 output lanes of one batch
// row, and its block loops over the input rows that feed them: no reduction
// across blocks.  Pivots are stored transposed and tile-major, so that a
// tile's 16-byte runs (one per input row) lie back to back and a warp's copies
// coalesce into whole cache lines:
//   dense planes   cinv_t[s, j, t, i_in, l] = Cinv^T[i_in, 8 t + l], all ld rows;
//   banded head    head[s, j, t, v, l]       = Cinv^T[8 t - half + v, 8 t + l],
//                  v < wt = 8 + 2 half: the window of input rows that reach the
//                  tile when |in - out| <= half (rows outside [0, n) are zero
//                  and are neither copied nor multiplied);
//   int8 planes    the dense layout in int8, 8 bytes a row, with the scales
//                  scale[s, j, t, b, part, l] (part 0 real, 1 imaginary) of
//                  input block b = i_in / 128 and output lane 8 t + l.
// In the banded+tail layout lines j < tail_start keep a head window and lines
// j >= tail_start a dense plane (tail[s, j - tail_start]).  The step only sees
// which input rows a tile's columns cover (Cols: rows i0 .. i0+cnt-1), so the
// two layouts share it.  w (2r x n floats) is small; every block recomputes all
// of it into shared memory from the carry in global memory (lanes o-1, o, o+1,
// zero outside [0, n)).  Threads stride over the input rows, each keeping 2r x
// 8 partial sums, and the block reduces them with warp shuffles and one pass
// through shared memory.
//
// Ordering of the lines.  Line j needs the COMPLETE t of the line before.
// The TPU runs its grid in order on one core; here a whole pass, or a whole
// sweep direction, is ONE COOPERATIVE LAUNCH whose blocks stay resident and
// meet at cooperative_groups::this_grid().sync() once per step.  The grid is
// sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor so that every block
// is co-resident (a launch that does not fit is refused with an error, it does
// not hang); a block takes several tiles per step when there are more tiles
// than resident blocks.
//
// What is on the critical path.  Between two barriers only the carry is new;
// a line's plane columns, bands and right-hand rows do not depend on it.  So
// they are copied into shared memory with cp.async one work item AHEAD, while
// the block still computes and waits at the barrier, and after the barrier a
// block issues one batch of loads (the carry, 2r x ld floats, read past the
// incoherent L1), forms w out of shared memory, multiplies, reduces and
// stores.  Measured on an H100 at n = 801: with every operand loaded where it
// is used, the dependent L2 round trips of the band step alone cost 8.6 us per
// line, against 1 us for the barrier and 0.4 us for the products.  A row that
// the step just before wrote (in the sweep kernels: the traces, and the y row
// of a backward pass's first line) is read after the barrier like the carry: a
// copy issued one item ahead would overtake its writing.  Rows written two or
// more barriers back are staged ahead like the rest.
//
// int8 planes (the JAX package's pallas_thomas.py:_scaled_dots, nb > 1).
// Quantization as there: per 128-row input block and output lane, scale =
// absmax / 127 and q = round(c / scale) clipped to +-127.  The planes keep the
// dense tile-major layout at the same ld = round_up(n, 8) as bf16 (the last
// scale block is partial; past row n it holds zeros, as the JAX package's
// 128-lane padding does, so the scales are the same numbers), so rows, bands
// and carries are shared with bf16 and a line's planes are 2 x ld^2 bytes
// (1.31 MB at n = 801, against 1.61 MB at the 3D convention's ld = 896).  A
// tile stages n rows of 8 bytes and its nb = ld / 128 (rounded up) x 2 x 8
// scales in the same cp.async group.  A thread walks input rows tid,
// tid + 128, ...: with 128 threads its k-th row lies in block k, so the 2 x 8
// scales of an iteration are one broadcast read of shared memory.  Each entry
// is dequantized before its product, as plane_pass.cuh does (the JAX kernel
// scales each block's partial sum instead: the two differ in f32 rounding
// only).  The bytes become floats by the byte-permute trick of
// plane_pass.cuh (design note 4 there).  Banded+tail pivots and the fused
// sweeps stay bf16 only, as in the JAX package.
//
// Limits.  r = 1 or 2 right-hand sides per launch (the wrappers run wider
// batches as groups of at most two), and a line whose rows and plane buffers
// fit in one block's shared memory (64 n bytes of bf16 planes, about 32 n of
// int8 ones, plus the rows: n up to 1704 in bf16 and 2200 in int8 at r = 2 on
// an H100 for the passes, about 1300 for the sweep kernels, which also keep
// the injection's band and trace).  Anything else is refused with
// cudaErrorInvalidValue before a launch.
//
// Bound: bytes.  A dense line must read its two planes once, 2 x ld^2 x 2 B
// (2.6 MB at n = 801, ld = 808), which the card's 3.35 TB/s moves in 0.78 us;
// an int8 line 2 x ld^2 B plus its scales (1.31 MB, 0.39 us); a head line its
// two windows, 2 x ld x wt x 2 B (0.67 MB at half = 100).  The
// arithmetic (2 x 2r x 2 x rows x ld flop) is far below the f32 rate.  Each
// plane byte is read exactly once per pass and serves all r right-hand sides.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace thomas {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;          // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;              // output lanes per tile (16 B of bf16)
constexpr int kMaxRhs = 2;             // right-hand sides per launch
constexpr int kCarryBatch = 8;         // float4 carry loads in flight per thread
constexpr int kScaleBlock = 128;       // input rows per int8 scale
static_assert(kThreads == kScaleBlock, "a thread's k-th input row lies in int8 block k");

enum class Storage : int { kBf16 = 0, kInt8 = 1 };

// Timing by ablation (benchmarks_torch/thomas_ablation.py): a build with
// -DTHOMAS_ABLATE=<mask> leaves single phases of a line out.  Its results are
// wrong and only its time is read; the package always builds with 0.
#ifndef THOMAS_ABLATE
#define THOMAS_ABLATE 0
#endif
constexpr bool kNoBandStep = THOMAS_ABLATE & 1;     // neither carry load nor band step
constexpr bool kNoProducts = THOMAS_ABLATE & 2;
constexpr bool kNoBarrier = THOMAS_ABLATE & 4;
constexpr bool kNoPlaneCopies = THOMAS_ABLATE & 8;
constexpr bool kNoRowCopies = THOMAS_ABLATE & 16;   // band and right-hand rows
constexpr bool kNoCarryLoad = THOMAS_ABLATE & 32;

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
// leaves q exactly (plane_pass.cuh, design note 4)
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

// The pivot columns of one tile of one line: input rows i0 .. i0+cnt-1, one
// run of 8 values per row (16 B of bf16, 8 B of int8), real and imaginary
// plane, and for int8 the tile's scales (nb x 2 x 8 floats; i0 = 0).
struct Cols {
  const unsigned char* re;
  const unsigned char* im;
  const float* scale;
  int i0, cnt;
};

// Where tile t of line j of slab s has its columns.  Lines j >= tail_start
// keep a dense plane, index j - tail_start in (cre, cim), of S x (m -
// tail_start) planes; lines j < tail_start a head window in (hre, him), of S x
// tail_start windows.  The dense layout is tail_start = 0.
__device__ __forceinline__ Cols tile_cols(const void* cre, const void* cim,
                                          const uint16_t* hre, const uint16_t* him,
                                          int s, int j, int t, int m, int n, int ld,
                                          int tail_start, int half) {
  const int tiles = ld / kLanes;
  Cols c;
  c.scale = nullptr;
  if (j < tail_start) {
    const int lo = t * kLanes - half;                // window row 0
    const int hi = t * kLanes + kLanes + half;       // one past the last
    c.i0 = lo < 0 ? 0 : lo;
    c.cnt = (hi < n ? hi : n) - c.i0;
    const size_t off = ((((size_t)s * tail_start + j) * tiles + t) * (kLanes + 2 * half) +
                        (c.i0 - lo)) * kLanes;
    c.re = reinterpret_cast<const unsigned char*>(hre + off);
    c.im = reinterpret_cast<const unsigned char*>(him + off);
  } else {
    const size_t off =
        (((size_t)s * (m - tail_start) + (j - tail_start)) * tiles + t) * (size_t)ld * kLanes;
    c.re = static_cast<const unsigned char*>(cre) + 2 * off;
    c.im = static_cast<const unsigned char*>(cim) + 2 * off;
    c.i0 = 0;
    c.cnt = n;
  }
  return c;
}

// Where tile t of line j of slab s has its columns in int8 planes (S x m
// dense planes, nb scale blocks of 128 input rows)
__device__ __forceinline__ Cols tile_cols_int8(const void* cre, const void* cim,
                                               const float* scale, int s, int j, int t, int m,
                                               int n, int ld) {
  const int tiles = ld / kLanes;
  const int nb = (ld + kScaleBlock - 1) / kScaleBlock;
  const size_t tile = ((size_t)s * m + j) * tiles + t;
  Cols c;
  c.re = static_cast<const unsigned char*>(cre) + tile * ld * kLanes;
  c.im = static_cast<const unsigned char*>(cim) + tile * ld * kLanes;
  c.scale = scale + tile * nb * 2 * kLanes;
  c.i0 = 0;
  c.cnt = n;
  return c;
}

// One work item: one tile of one line, with every operand's address.
struct Tile {
  Cols cols;
  const float* band;     // (2, 3, ld) [re, im] x tap x lane, applied to prev
  const float* rhs;      // (2R, ld) right-hand rows
  const float* prev;     // (2R, ld) carry, or nullptr for a zero carry
  const float* cpl;      // (2, 3, ld) injection band, or nullptr for none
  const float* trace;    //   the (2R, ld) trace it multiplies
  float* kept;           // w is kept here (this tile's lanes), or nullptr
  float* out;            // t (this tile's lanes)
  float* out2;           // a second copy of t, or nullptr ...
  const float* sub2;     //   ... less this vector (nullptr: none)
  float sign;            // +1 or -1: the injection is added or subtracted
  bool rhs_late;         // rhs written by this launch: read after the barrier
  int o0;                // first output lane of the tile
  int step;              // items of one step share it; a barrier between steps
};

__device__ __forceinline__ Tile plain_tile(int o0, int step) {
  Tile tl;
  tl.band = tl.rhs = tl.prev = tl.cpl = tl.trace = tl.sub2 = nullptr;
  tl.kept = tl.out = tl.out2 = nullptr;
  tl.sign = 1.f;
  tl.rhs_late = false;
  tl.o0 = o0;
  tl.step = step;
  return tl;
}

// Bytes of one staged plane buffer: n rows of 16 bytes (bf16), or n rows of 8
// bytes rounded up to whole 16-byte copies (int8)
template <Storage S>
__host__ __device__ constexpr size_t plane_buf_bytes(int n) {
  return S == Storage::kInt8 ? (size_t)16 * ((n + 1) / 2) : (size_t)16 * n;
}

// Bytes of the staged scales of one buffer: nb blocks x 2 parts x 8 lanes
template <Storage S>
__host__ __device__ constexpr size_t scale_buf_bytes(int ld) {
  return S == Storage::kInt8 ? sizeof(float) * 2 * kLanes * ((ld + kScaleBlock - 1) / kScaleBlock)
                             : 0;
}

// Shared memory of one block: the plane buffers (two buffers x two planes),
// the int8 scales (two buffers), then float rows.  Rows are ld floats wide;
// the carry and trace rows have 4 zero floats on either side so that lanes -1
// and ld read as zero and float4 stores stay aligned.  kInject adds the
// injection's band and trace.
template <int R, bool kInject, Storage S = Storage::kBf16>
__host__ __device__ constexpr size_t smem_bytes(int n, int ld) {
  return 4 * plane_buf_bytes<S>(n) + 2 * scale_buf_bytes<S>(ld) +
         sizeof(float) * ((size_t)(6 + 2 * 2 * R) * ld + (size_t)2 * R * (ld + 8) +
                          kWarps * 2 * R * kLanes +
                          (kInject ? (size_t)6 * ld + (size_t)2 * R * (ld + 8) : 0));
}

// Loads a (2R, ld) row block that other blocks wrote, past the (incoherent)
// L1, into shared rows of pitch `pitch`; lanes >= n count as zero.  All loads
// of a batch are issued before the first is used.
template <int R>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src, int n,
                                          int ld) {
  const int ld4 = ld / 4;
  for (int base = threadIdx.x; base < 2 * R * ld4; base += kThreads * kCarryBatch) {
    float4 v[kCarryBatch];
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < 2 * R * ld4) v[u] = __ldcg(reinterpret_cast<const float4*>(src) + i);
    }
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      const int i = base + u * kThreads;
      if (i >= 2 * R * ld4) continue;
      const int qq = i / ld4, c = (i - qq * ld4) * 4;
      if (c + 3 >= n) {    // padding lanes count as zero
        if (c >= n) v[u].x = 0.f;
        if (c + 1 >= n) v[u].y = 0.f;
        if (c + 2 >= n) v[u].z = 0.f;
        v[u].w = 0.f;
      }
      *reinterpret_cast<float4*>(dst + qq * pitch + c) = v[u];
    }
  }
}

// The line steps of one block: items.tile(q) for q < nitem, in order, with a
// grid barrier wherever the step changes.  Items is a step map:
//     __device__ Tile tile(int q) const;   // the item's operands and step
template <int R, bool kInject, Storage S = Storage::kBf16, class Items>
__device__ __forceinline__ void run_steps(const Items& items, int nitem, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldp = ld + 8;
  // staged[buf][plane]: one run of 8 lanes per input row (a uint4 of bf16 or
  // a uint2 of int8), then for int8 s_scale[buf]: [block][part][lane]
  const size_t pbytes = plane_buf_bytes<S>(n);
  unsigned char* staged = smem_raw;
  float* s_scale = reinterpret_cast<float*>(smem_raw + 4 * pbytes);
  const int nsc = (int)(scale_buf_bytes<S>(ld) / sizeof(float));     // floats a buffer
  float* s_band = reinterpret_cast<float*>(smem_raw + 4 * pbytes + 2 * scale_buf_bytes<S>(ld));
  float* s_rhs = s_band + 6 * ld;           // [2R][ld]
  float* w = s_rhs + 2 * R * ld;            // [2R][ld]
  float* s_prev = w + 2 * R * ld;           // [2R][4 + ld + 4]
  float* red = s_prev + 2 * R * ldp;        // [kWarps][2R * kLanes]
  float* s_cpl = red + kWarps * 2 * R * kLanes;   // kInject: [6][ld]
  float* s_trace = s_cpl + 6 * ld;                //   and [2R][4 + ld + 4]

  const int tid = threadIdx.x;
  const int ld4 = ld / 4;                   // float4 per float row

  // the next item's operands that do not depend on the step before
  auto stage = [&](const Tile& tl, int buf) {
    if (!kNoRowCopies) {
      for (int i = tid; i < 6 * ld4; i += kThreads) cp_async16(s_band + 4 * i, tl.band + 4 * i);
      if (!tl.rhs_late)
        for (int i = tid; i < 2 * R * ld4; i += kThreads) cp_async16(s_rhs + 4 * i, tl.rhs + 4 * i);
      if (kInject && tl.cpl != nullptr)
        for (int i = tid; i < 6 * ld4; i += kThreads) cp_async16(s_cpl + 4 * i, tl.cpl + 4 * i);
    }
    if (!kNoPlaneCopies) {
      // 16-byte copies: one bf16 row, or two int8 rows (an odd count reads
      // one padding row, which is zero and is not multiplied)
      const int copies = S == Storage::kInt8 ? (tl.cols.cnt + 1) / 2 : tl.cols.cnt;
      const uint4* gre = reinterpret_cast<const uint4*>(tl.cols.re);
      const uint4* gim = reinterpret_cast<const uint4*>(tl.cols.im);
      uint4* sre = reinterpret_cast<uint4*>(staged + (size_t)buf * 2 * pbytes);
      uint4* sim = reinterpret_cast<uint4*>(staged + (size_t)buf * 2 * pbytes + pbytes);
      for (int i = tid; i < copies; i += kThreads) {
        cp_async16(sre + i, gre + i);
        cp_async16(sim + i, gim + i);
      }
      if (S == Storage::kInt8)
        for (int i = tid; i < nsc / 4; i += kThreads)
          cp_async16(s_scale + buf * nsc + 4 * i, tl.cols.scale + 4 * i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  for (int i = tid; i < 2 * R * 8; i += kThreads) {   // zero guards of s_prev, s_trace
    const int at = (i / 8) * ldp + (i % 8 < 4 ? i % 8 : ld + i % 8);
    s_prev[at] = 0.f;
    if (kInject) s_trace[at] = 0.f;
  }
  Tile tl = items.tile(0);           // the grid is no larger than a step's tiles:
  stage(tl, 0);                      //   every block has items

  for (int q = 0; q < nitem; ++q) {
    const bool more = q + 1 < nitem;
    const bool carry_in = tl.prev != nullptr && !kNoBandStep;
    const bool inject = kInject && tl.cpl != nullptr;

    // 1. what the barrier was waiting for: the carry, and rows of this launch
    if (carry_in && !kNoCarryLoad) load_rows<R>(s_prev + 4, ldp, tl.prev, n, ld);
    if (tl.rhs_late) load_rows<R>(s_rhs, ld, tl.rhs, n, ld);
    if (inject) load_rows<R>(s_trace + 4, ldp, tl.trace, n, ld);
    // this item's planes, bands and right-hand rows were requested during the
    // item before: they have landed by now
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // 2. w = rhs [+- cpl . trace] - band . prev for every lane
    for (int i = tid; i < n; i += kThreads) {
      float accr[R], acci[R], injr[R], inji[R];
#pragma unroll
      for (int p = 0; p < R; ++p) accr[p] = acci[p] = injr[p] = inji[p] = 0.f;
      if (carry_in) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float br = s_band[d * ld + i];
          const float bi = s_band[(3 + d) * ld + i];
#pragma unroll
          for (int p = 0; p < R; ++p) {
            const float tr = s_prev[p * ldp + 3 + i + d];
            const float ti = s_prev[(R + p) * ldp + 3 + i + d];
            accr[p] = accr[p] + br * tr - bi * ti;
            acci[p] = acci[p] + br * ti + bi * tr;
          }
        }
      }
      if (inject) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float br = s_cpl[d * ld + i];
          const float bi = s_cpl[(3 + d) * ld + i];
#pragma unroll
          for (int p = 0; p < R; ++p) {
            const float tr = s_trace[p * ldp + 3 + i + d];
            const float ti = s_trace[(R + p) * ldp + 3 + i + d];
            injr[p] = injr[p] + br * tr - bi * ti;
            inji[p] = inji[p] + br * ti + bi * tr;
          }
        }
      }
#pragma unroll
      for (int p = 0; p < R; ++p) {
        w[p * ld + i] = (s_rhs[p * ld + i] + tl.sign * injr[p]) - accr[p];
        w[(R + p) * ld + i] = (s_rhs[(R + p) * ld + i] + tl.sign * inji[p]) - acci[p];
      }
    }
    __syncthreads();
    if (more) stage(items.tile(q + 1), (q + 1) & 1);   // row buffers are free again

    // w is kept where the step wants it; each tile writes its own lanes
    if (tl.kept != nullptr && tid < 2 * R * kLanes) {
      const int qq = tid / kLanes, o = tl.o0 + tid % kLanes;
      tl.kept[qq * ld + o] = o < n ? w[qq * ld + o] : 0.f;
    }

    // 3. partial products over this thread's input rows, both planes
    float zre[2 * R][kLanes], zim[2 * R][kLanes];
#pragma unroll
    for (int qq = 0; qq < 2 * R; ++qq)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) zre[qq][l] = zim[qq][l] = 0.f;

    const unsigned char* pre = staged + (size_t)(q & 1) * 2 * pbytes;
    const unsigned char* pim = pre + pbytes;
    const float* sc = s_scale + (q & 1) * nsc;
    const float* wi = w + tl.cols.i0;
#pragma unroll 4
    for (int i = tid; i < (kNoProducts ? 0 : tl.cols.cnt); i += kThreads) {
      float cr[kLanes], ci[kLanes];
      if (S == Storage::kInt8) {
        // input row i lies in scale block i / 128 (i0 = 0): the same block
        // for the whole warp, a broadcast read
        widen_s8x8(reinterpret_cast<const uint2*>(pre)[i], cr);
        widen_s8x8(reinterpret_cast<const uint2*>(pim)[i], ci);
        const float* sb = sc + (i / kScaleBlock) * 2 * kLanes;
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          cr[l] *= sb[l];
          ci[l] *= sb[kLanes + l];
        }
      } else {
        widen_bf16x8(reinterpret_cast<const uint4*>(pre)[i], cr);
        widen_bf16x8(reinterpret_cast<const uint4*>(pim)[i], ci);
      }
#pragma unroll
      for (int qq = 0; qq < 2 * R; ++qq) {
        const float wq = wi[qq * ld + i];
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          zre[qq][l] += wq * cr[l];
          zim[qq][l] += wq * ci[l];
        }
      }
    }

    // 4. complex recombination (linear, so it commutes with the reduction):
    //    t_re = Wr.Cre - Wi.Cim,  t_im = Wi.Cre + Wr.Cim
    float t[2 * R][kLanes];
#pragma unroll
    for (int p = 0; p < R; ++p)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        t[p][l] = zre[p][l] - zim[R + p][l];
        t[R + p][l] = zre[R + p][l] + zim[p][l];
      }

    // 5. reduce over the block's threads: shuffles inside a warp, then shared
#pragma unroll
    for (int qq = 0; qq < 2 * R; ++qq)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        float v = t[qq][l];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        t[qq][l] = v;
      }
    if ((tid & 31) == 0) {
#pragma unroll
      for (int qq = 0; qq < 2 * R; ++qq)
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
          red[(tid >> 5) * 2 * R * kLanes + qq * kLanes + l] = t[qq][l];
    }
    __syncthreads();
    if (tid < 2 * R * kLanes) {
      float v = 0.f;
#pragma unroll
      for (int wi2 = 0; wi2 < kWarps; ++wi2) v += red[wi2 * 2 * R * kLanes + tid];
      const int at = (tid / kLanes) * ld + tl.o0 + tid % kLanes;
      tl.out[at] = v;
      if (tl.out2 != nullptr) tl.out2[at] = tl.sub2 != nullptr ? v - tl.sub2[at] : v;
    }

    // every block passes here once per step but the last: all tiles of a step
    // are complete before any block starts the next one.  The next item's
    // addresses are worked out before the barrier, off the critical path.
    if (more) {
      const Tile next = items.tile(q + 1);
      if (next.step != tl.step && !kNoBarrier) cg::this_grid().sync();
      tl = next;
    }
  }
}

// Launches `kernel` cooperatively with as many co-resident blocks as it can
// use, at most `tiles` (one per tile of a step).
template <class Kernel, class Args>
inline cudaError_t launch_cooperative(Kernel kernel, const Args& a, size_t smem, int tiles,
                                      cudaStream_t stream) {
  // These queries run on every launch; keeping their results per shape did
  // not change the host's time per launch on an H100 (PERF.md).
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;   // line too long
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  Args args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kThreads), params, smem,
                                     stream);
}

// ---------------------------------------------------------------------------
// The substitution passes: one batch of rows, lines first, first +- 1, ...
// ---------------------------------------------------------------------------

struct PassArgs {
  const float* rhs;        // (B, m, 2r, ld) right-hand rows of the pass
  const float* band;       // (S, m, 2, 3, ld) [re, im] x tap x lane
  const void* cre;         // dense layout: (S, m, ld/8, ld, 8) bf16 bits or
  const void* cim;         //   int8, tile-major, transposed pivot, real and
                           //   imaginary plane; banded+tail: the bf16 tail
                           //   planes (S, m - tail_start, ld/8, ld, 8)
  const float* scale;      // int8: (S, m, ld/8, nb, 2, 8) scales; else unused
  const uint16_t* hre;     // banded+tail: the head windows
  const uint16_t* him;     //   (S, tail_start, ld/8, 8 + 2 half, 8); else unused
  const int* s_idx;        // (B,) slab of each batch row
  const float* t_init;     // cached forward: (B, 2r, ld) carry into line `first`;
                           //   else unused
  float* kept;             // forward, cached forward: y stack (B, m, 2r, ld),
                           //   w is kept here (lines of the pass only);
                           //   backward: unused
  float* out;              // forward: carry scratch (2, B, 2r, ld);
                           //   cached forward: t stack (B, m, 2r, ld), lines of
                           //   the pass only; backward: x stack (B, count, 2r, ld)
  int batch, m, n, ld;
  int first;               // first line of the pass (zero carry before it)
  int count;               // number of lines: first, first+1, ... in a forward
                           //   pass, first, first-1, ... in a backward pass
  int tail_start;          // banded+tail: first line with a dense plane; else 0
  int half;                // banded+tail: kept band half-width; else 0
};

// R = number of right-hand sides r (rows are 2R); kBackward = bottom-up pass;
// kCached = forward pass that starts from t_init and keeps the t stack;
// kBanded = banded+tail pivot layout; S = storage of dense pivot planes.
template <int R, bool kBackward, bool kCached, bool kBanded, Storage S>
struct PassItems {
  PassArgs a;
  int tiles_blk, tiles_row;

  __device__ __forceinline__ Tile tile(int q) const {
    const int k = q / tiles_blk;
    const int tile = blockIdx.x + (q - k * tiles_blk) * gridDim.x;
    const int j = kBackward ? a.first - k : a.first + k;
    const int b = tile / tiles_row;
    const int t = tile - b * tiles_row;
    const int s = __ldg(a.s_idx + b);
    const size_t row = (size_t)2 * R * a.ld;      // floats per (batch row, line)
    Tile tl = plain_tile(t * kLanes, k);
    if constexpr (S == Storage::kInt8)
      tl.cols = tile_cols_int8(a.cre, a.cim, a.scale, s, j, t, a.m, a.n, a.ld);
    else
      tl.cols = tile_cols(a.cre, a.cim, a.hre, a.him, s, j, t, a.m, a.n, a.ld,
                          kBanded ? a.tail_start : 0, kBanded ? a.half : 0);
    tl.band = a.band + ((size_t)s * a.m + j) * 6 * a.ld;
    tl.rhs = a.rhs + ((size_t)b * a.m + j) * row;
    if (kBackward) {         // x stack holds lines first-count+1 .. first
      float* x = a.out + ((size_t)b * a.count + (j - (a.first - a.count + 1))) * row;
      tl.out = x;
      tl.prev = j != a.first ? x + row : nullptr;
    } else if (kCached) {    // t stack holds lines first .. m-1; t_init before them
      float* tt = a.out + ((size_t)b * a.m + j) * row;
      tl.out = tt;
      tl.prev = j == a.first ? a.t_init + (size_t)b * row : tt - row;
      tl.kept = a.kept + ((size_t)b * a.m + j) * row;
    } else {                 // two-slot ping-pong carry
      tl.out = a.out + ((size_t)(j & 1) * a.batch + b) * row;
      tl.prev = j != a.first ? a.out + ((size_t)((j - 1) & 1) * a.batch + b) * row : nullptr;
      tl.kept = a.kept + ((size_t)b * a.m + j) * row;
    }
    return tl;
  }
};

template <int R, bool kBackward, bool kCached, bool kBanded = false,
          Storage S = Storage::kBf16>
__global__ void __launch_bounds__(kThreads) pass_kernel(const PassArgs a) {
  const int tiles_row = a.ld / kLanes;
  const int total = a.batch * tiles_row;
  const int tiles_blk = (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const PassItems<R, kBackward, kCached, kBanded, S> items{a, tiles_blk, tiles_row};
  run_steps<R, false, S>(items, a.count * tiles_blk, a.n, a.ld);
}

template <bool kBackward, bool kCached, bool kBanded, Storage S>
inline cudaError_t run_pass_as(int r, const PassArgs& a, cudaStream_t stream) {
  if (a.batch < 1 || a.m < 1 || a.n < 1 || a.ld < a.n || a.ld % kLanes != 0 ||
      r < 1 || r > kMaxRhs || a.count < 1 || a.first < 0 || a.first >= a.m)
    return cudaErrorInvalidValue;
  if (kBanded && (a.tail_start < 1 || a.tail_start >= a.m || a.half < 0))
    return cudaErrorInvalidValue;
  const int tiles = a.batch * (a.ld / kLanes);
  return r == 1
             ? launch_cooperative(pass_kernel<1, kBackward, kCached, kBanded, S>, a,
                                  smem_bytes<1, false, S>(a.n, a.ld), tiles, stream)
             : launch_cooperative(pass_kernel<2, kBackward, kCached, kBanded, S>, a,
                                  smem_bytes<2, false, S>(a.n, a.ld), tiles, stream);
}

// Launches a pass on the layout the arguments name: int8 planes when scales
// are given (dense layout only), banded+tail when kBanded, else dense bf16
template <bool kBackward, bool kCached = false, bool kBanded = false>
inline cudaError_t run_pass(int r, const PassArgs& a, cudaStream_t stream) {
  if (a.scale != nullptr)
    return kBanded ? cudaErrorInvalidValue
                   : run_pass_as<kBackward, kCached, false, Storage::kInt8>(r, a, stream);
  return run_pass_as<kBackward, kCached, kBanded, Storage::kBf16>(r, a, stream);
}

}  // namespace thomas
