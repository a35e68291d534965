// Block-Thomas line kernels: what the 2D substitution kernels share
//
// The layouts of the pivots, the numerics contract, the bound, and the device
// helpers that find one tile's pivot columns.  Every line kernel runs the
// flag-handoff line step of thomas_flow.cuh, which holds the kernels, their
// design and their limits:
//
//     flow_kernel<R, false|true, S, SPLIT>   dense forward / backward pass
//     cached_kernel<R, kBanded, S, SPLIT>    cached forward pass (dense or
//                                            banded+tail pivots)
//     pass_map_kernel<R, true, kBf16, true, SPLIT>
//                                            backward pass on banded+tail pivots
//     sweep::down_kernel, up_kernel          whole Gauss-Seidel sweep directions
//
// Every kernel is a walk over line steps; a kernel differs from the others
// only in the order of its steps and in where each step's operands come from
// and go to.  Direction, caching, the pivot layout and the pivot storage
// (bf16, or int8 with f32 scales) are template parameters, so that each
// kernel is a kernel of its own (and has its own name in a profiler's trace).
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
// Layouts.  A tile is kLanes = 8 output lanes of one batch row.  Pivots are
// stored transposed and tile-major, so that a tile's 16-byte runs (one per
// input row) lie back to back and one bulk copy stages them:
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
// two layouts share it.
//
// int8 planes (the JAX package's pallas_thomas.py:_scaled_dots, nb > 1).
// Quantization as there: per 128-row input block and output lane, scale =
// absmax / 127 and q = round(c / scale) clipped to +-127.  The planes keep the
// dense tile-major layout at the same ld = round_up(n, 8) as bf16 (the last
// scale block is partial; past row n it holds zeros, as the JAX package's
// 128-lane padding does, so the scales are the same numbers), so rows, bands
// and carries are shared with bf16 and a line's planes are 2 x ld^2 bytes
// (1.31 MB at n = 801, against 1.61 MB at the 3D convention's ld = 896).
// Each entry is dequantized before its product, as plane_pass.cuh does (the
// JAX kernel scales each block's partial sum instead: the two differ in f32
// rounding only).  The bytes become floats by the byte-permute trick of
// plane_pass.cuh (design note 4 there).  Banded+tail pivots and the fused
// sweeps stay bf16 only, as in the JAX package.
//
// Bound: bytes.  A dense line must read its two planes once, 2 x ld^2 x 2 B
// (2.6 MB at n = 801, ld = 808), which the card's 3.35 TB/s moves in 0.78 us;
// an int8 line 2 x ld^2 B plus its scales (1.31 MB, 0.39 us); a head line its
// two windows, 2 x ld x wt x 2 B (0.67 MB at half = 100).  The
// arithmetic (2 x 2r x 2 x rows x ld flop) is far below the f32 rate.  Each
// plane byte is read exactly once per pass and serves all r right-hand sides
// (up to 16 in one launch on either layout: thomas_flow.cuh, "Wide batches").
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace thomas {

constexpr int kLanes = 8;              // output lanes per tile (16 B of bf16)
constexpr int kMaxRhs = 16;            // right-hand sides per launch: 1, 2, 4, 8 or 16

// The widths a line kernel's launch is instantiated for; the wrappers pad
// other r up to the next one with zero right-hand sides
// (sparse/thomas_kernels.py).  The plane kernels stop at 8 (plane_pass.cuh:
// plane::launch_width).
__host__ __device__ constexpr bool launch_width(int r) {
  return r == 1 || r == 2 || r == 4 || r == 8 || r == 16;
}
constexpr int kScaleBlock = 128;       // input rows per int8 scale

enum class Storage : int { kBf16 = 0, kInt8 = 1 };

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

// Bytes of the staged scales of one buffer: nb blocks x 2 parts x 8 lanes
template <Storage S>
__host__ __device__ constexpr size_t scale_buf_bytes(int ld) {
  return S == Storage::kInt8 ? sizeof(float) * 2 * kLanes * ((ld + kScaleBlock - 1) / kScaleBlock)
                             : 0;
}

// The operands of one pass, as the launchers receive them
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
  float* out;              // forward: unused (the carry lives in the exchange words);
                           //   cached forward: t stack (B, m, 2r, ld), lines of
                           //   the pass only; backward: x stack (B, count, 2r, ld)
  int batch, m, n, ld;
  int first;               // first line of the pass (zero carry before it)
  int count;               // number of lines: first, first+1, ... in a forward
                           //   pass, first, first-1, ... in a backward pass
  int tail_start;          // banded+tail: first line with a dense plane; else 0
  int half;                // banded+tail: kept band half-width; else 0
  float* rows;             // r = 4, 8, 16: the wide step's rows buffer (thomas_flow.cuh,
                           //   wide_slot_bytes a slot and batch row); else unused
};

}  // namespace thomas
