// Tensor-core products of wide batches: what the line kernels
// (thomas_flow.cuh, "Wide batches") and the plane kernels (plane_pass.cuh,
// note 4) take at r = 4 and 8 right-hand sides.
//
// A warp multiplies a run of staged pivot rows by the batch's rows as
// mma.sync.aligned.m16n8k16 products, bf16 operands and f32 sums:
//
//     M = the 2r stacked rows: re_p in fragment row p, im_p in row 8 + p
//         (zero rows where p >= r), so that a lane holds both halves of its
//         outputs and the complex recombination is lane-local;
//     N = the tile's 8 output lanes;
//     K = 16 input rows a step.
//
// The B operand is a pivot run as it lies in shared memory: a row-major
// K x 8 tile, 16 bytes a row in bf16, or 8 in int8, widened to bf16 exactly
// (|q| <= 127 needs 7 bits).  The A operand is the f32 rows split into three
// bf16 terms, y = h + m + l with each difference exact in f32 (about 24 bits,
// f32's own precision; two terms would keep about 16, TF32 10), so that the
// products keep the f32 numbers of the numerics contract (thomas_line.cuh,
// plane_pass.cuh): against the plain versions' f32 products the difference
// is summation order.  int8: a segment of rows lies in one 128-row scale
// block, and its partial sums are multiplied by the block's scale of each
// output lane before they are added (the TPU kernels' order, _scaled_dots /
// _dot_plane).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wide {

constexpr int kLanes = 8;              // output lanes of a tile (N)
constexpr int kSegRows = 64;           // input rows of a segment
constexpr int kScaleBlock = 128;       // input rows per int8 scale

// two floats as bf16x2, rounded to nearest: lo in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// y0, y1 as three bf16x2 terms h + m + l (each difference exact in f32)
__device__ __forceinline__ void split3(float y0, float y1, unsigned& h, unsigned& m,
                                       unsigned& l) {
  h = pack_bf16x2(y0, y1);
  const float r0 = y0 - __uint_as_float(h << 16), r1 = y1 - __uint_as_float(h & 0xffff0000u);
  m = pack_bf16x2(r0, r1);
  const float s0 = r0 - __uint_as_float(m << 16), s1 = r1 - __uint_as_float(m & 0xffff0000u);
  l = pack_bf16x2(s0, s1);
}

// d += a . b: one m16n8k16 product, bf16 operands, f32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 bits of input row k, output lane n of a staged pivot run (bf16: 16 B a
// row; int8: 8 B a row, widened exactly); zero from row `end` on
template <bool kInt8>
__device__ __forceinline__ unsigned pivot_bits(const unsigned char* run, int k, int n, int end) {
  if (k >= end) return 0u;
  if (!kInt8) return reinterpret_cast<const uint16_t*>(run)[k * kLanes + n];
  const int q = reinterpret_cast<const signed char*>(run)[k * kLanes + n];
  return __float_as_uint((float)q) >> 16;
}

// The B fragment of input rows kb .. kb + 15 of a run: lane (g, t) holds rows
// kb + 2t, + 1 and kb + 2t + 8, + 9 of output lane g
template <bool kInt8>
__device__ __forceinline__ void b_frag(const unsigned char* run, int kb, int end, int g, int t,
                                       unsigned& b0, unsigned& b1) {
  const int k = kb + 2 * t;
  b0 = pivot_bits<kInt8>(run, k, g, end) | (pivot_bits<kInt8>(run, k + 1, g, end) << 16);
  b1 = pivot_bits<kInt8>(run, k + 8, g, end) | (pivot_bits<kInt8>(run, k + 9, g, end) << 16);
}

// The A fragments (three bf16 terms) of columns kb .. kb + 15 of the f32 rows
// (row q at y + q * yp, 8-byte aligned at even columns; columns from `end` on
// read as zero): fragment row g is re_g (y row g), row 8 + g is im_g (y row
// R + g), zero for g >= R
template <int R>
__device__ __forceinline__ void a_frags(const float* y, int yp, int kb, int end, int g, int t,
                                        unsigned (&ah)[4], unsigned (&am)[4], unsigned (&al)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = (q & 1) ? R + g : g;
    const int col = kb + 2 * t + (q >= 2 ? 8 : 0);      // even
    float2 v = make_float2(0.f, 0.f);
    if (g < R && col + 1 < end)
      v = *reinterpret_cast<const float2*>(y + (size_t)row * yp + col);
    else if (g < R && col < end)
      v.x = y[(size_t)row * yp + col];
    split3(v.x, v.y, ah[q], am[q], al[q]);
  }
}

// One warp's products of the input rows s0 .. min(s0 + kSegRows, end) - 1 of
// a staged run (both pivot parts, the imaginary `im` bytes after the real;
// y holding the same rows' columns): z1 += Y . Pre, z2 += Y . Pim as m16n8k16
// accumulator fragments (lane (g, t): rows g and 8 + g, output lanes 2t and
// 2t + 1).  int8: the rows lie in one scale block, whose scales ([part][lane]
// floats at sb) multiply the partial sums before they are added.
template <int R, bool kInt8>
__device__ __forceinline__ void seg_products(const unsigned char* sre, int im, const float* sb,
                                             const float* y, int yp, int s0, int end,
                                             float (&z1)[4], float (&z2)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto steps = [&](float (&d1)[4], float (&d2)[4]) {
#pragma unroll
    for (int kk = 0; kk < kSegRows; kk += 16) {
      const int kb = s0 + kk;
      if (kb >= end) break;
      unsigned ah[4], am[4], al[4], br0, br1, bi0, bi1;
      a_frags<R>(y, yp, kb, end, g, t, ah, am, al);
      b_frag<kInt8>(sre, kb, end, g, t, br0, br1);
      b_frag<kInt8>(sre + im, kb, end, g, t, bi0, bi1);
      // the step's three terms (the small ones first) on fresh sums, added
      // to the running ones in f32 (rounded to nearest), so that no chain of
      // the tensor cores' own f32 sums runs longer than one step
      float e1[4] = {0.f, 0.f, 0.f, 0.f}, e2[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(e1, al, br0, br1);
      mma16816(e2, al, bi0, bi1);
      mma16816(e1, am, br0, br1);
      mma16816(e2, am, bi0, bi1);
      mma16816(e1, ah, br0, br1);
      mma16816(e2, ah, bi0, bi1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        d1[q] += e1[q];
        d2[q] += e2[q];
      }
    }
  };
  if constexpr (kInt8) {
    float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
    steps(p1, p2);
    const float r0 = sb[2 * t], r1 = sb[2 * t + 1];
    const float i0 = sb[kLanes + 2 * t], i1 = sb[kLanes + 2 * t + 1];
    z1[0] += r0 * p1[0];
    z1[1] += r1 * p1[1];
    z1[2] += r0 * p1[2];
    z1[3] += r1 * p1[3];
    z2[0] += i0 * p2[0];
    z2[1] += i1 * p2[1];
    z2[2] += i0 * p2[2];
    z2[3] += i1 * p2[3];
  } else {
    steps(z1, z2);
  }
}

// This warp's part of a tile's 2R x 8 values from its fragments: t_re of
// right-hand side g = z1[g] - z2[8 + g], t_im = z1[8 + g] + z2[g] (lane-local),
// value v = row * 8 + lane at part[v * pitch + warp]
template <int R>
__device__ __forceinline__ void store_part(const float (&z1)[4], const float (&z2)[4],
                                           float* part, int pitch, int warp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (g >= R) return;
  const int re = g * kLanes + 2 * t, imv = (R + g) * kLanes + 2 * t;
  part[re * pitch + warp] = z1[0] - z2[2];
  part[(re + 1) * pitch + warp] = z1[1] - z2[3];
  part[imv * pitch + warp] = z1[2] + z2[0];
  part[(imv + 1) * pitch + warp] = z1[3] + z2[1];
}

// One item of a line kernel (thomas_flow.cuh): the rows row0 .. row0 + rows -
// 1 of a tile's staged pivot run (both parts, the imaginary `im` bytes after
// the real; int8: the tile's scales sc, [block][part][lane] by absolute
// block) times w (w[p * pitch + i - row0]), each warp taking the 64-row
// segments of the absolute rows in turn (a segment lies in one 128-row
// block), its part of the 2R x 8 values stored at part[v * kPitch + warp]
template <int R, bool kInt8, int kWarps>
__device__ __forceinline__ void line_products(const unsigned char* pre, int im, const float* sc,
                                              const float* w, int pitch, int rows, int row0,
                                              float* part, int kPitch, bool products) {
  const int warp = threadIdx.x >> 5;
  float z1[4] = {0.f, 0.f, 0.f, 0.f}, z2[4] = {0.f, 0.f, 0.f, 0.f};
  const int end = row0 + rows;
  for (int j = row0 / kSegRows + warp; products && j * kSegRows < end; j += kWarps) {
    const int a = max(j * kSegRows, row0), b = min((j + 1) * kSegRows, end);
    seg_products<R, kInt8>(pre, im, sc + (j * kSegRows / kScaleBlock) * 2 * kLanes, w, pitch,
                           a - row0, b - row0, z1, z2);
  }
  store_part<R>(z1, z2, part, kPitch, warp);
}

}  // namespace wide
