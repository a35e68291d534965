// Tensor-core products of wide batches: what the line kernels
// (thomas_flow.cuh, "Wide batches") take at r = 4, 8 and 16 right-hand sides
// and the plane kernels (plane_pass.cuh, note 4) at r = 4 and 8.
//
// A warp multiplies a run of staged pivot rows by the batch's rows as
// mma.sync.aligned.m16n8k16 products, bf16 operands and f32 sums:
//
//     M = the 2r stacked rows: at r = 8 re_p in fragment row p, im_p in row
//         8 + p, so that a lane holds both halves of its outputs and the
//         complex recombination is lane-local; at r = 16 two such tiles,
//         right-hand sides 0-7 and 8-15, each multiplied by the same B
//         fragments (loaded once); at r = 4, whose 8 rows fill
//         half of M, rows 0-7 take the h term of the rows and rows 8-15 their
//         m term, a second product the l term (two products a part instead of
//         three), and a lane adds its two row halves;
//     N = the tile's 8 output lanes;
//     K = 16 input rows a step (a k-step).
//
// The B operand is a pivot run as it lies in shared memory: a row-major
// K x 8 tile, 16 bytes a row in bf16, or 8 in int8, widened to bf16 exactly
// (|q| <= 127 needs 7 bits).  The A operand is the f32 rows split into three
// bf16 terms, y = h + m + l with each difference exact in f32 (about 24 bits,
// f32's own precision; two terms would keep about 16, TF32 10), so that the
// products keep the f32 numbers of the numerics contract (thomas_line.cuh,
// plane_pass.cuh): against the plain versions' f32 products the difference
// is summation order.  Each k-step's products run on fresh sums, added to
// the running ones in f32.  int8: a k-step lies in one 128-row scale block,
// and its partial sums are multiplied by the block's scale of each output
// lane before they are added (the TPU kernels' order, _scaled_dots /
// _dot_plane).
//
// A warp splits the 16 columns of a k-step once and multiplies them into
// every tile it takes (the plane kernels: every tile of its CTA; the line
// kernels: every tile of a line and batch row that its CTA takes, from
// fragments kept in shared memory); the B fragments come whole from shared
// memory: bf16 runs by ldmatrix.trans (the 16-byte rows of a run are 8 x 8
// core matrices), int8 runs a byte an entry, widened by a byte permute and a
// subtraction (no conversion instruction).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wide {

constexpr int kLanes = 8;              // output lanes of a tile (N)
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

// y rows of a k-step staged by a warp: 2R rows of 16 columns at a pitch of 24
// floats (the fragment loads of a half-warp meet no bank twice)
constexpr int kYPitch = 24;

// The A fragments of a k-step from the f32 pairs a lane holds: R = 8, v[q]
// the columns 2t, 2t + 1 (q < 2) or 2t + 8, + 9 (q >= 2) of row g (q even,
// re_g) or 8 + g (q odd, im_g), three terms each.  R = 4, v[q] (q < 2) the
// columns 2t + 8q, + 1 of row g: a[0] = {h, m} of row g (fragment rows g and
// 8 + g), a[1] = {l, 0}; a[2] unused.
template <int R>
__device__ __forceinline__ void a_frags_of(const float2 (&v)[4], unsigned (&a)[3][4]) {
  if constexpr (R == 8) {
#pragma unroll
    for (int q = 0; q < 4; ++q) split3(v[q].x, v[q].y, a[0][q], a[1][q], a[2][q]);
  } else {
    static_assert(R == 4, "wide step: r = 4 or 8");
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      unsigned h, m, l;
      split3(v[q].x, v[q].y, h, m, l);
      a[0][2 * q] = h;
      a[0][2 * q + 1] = m;
      a[1][2 * q] = l;
      a[1][2 * q + 1] = 0u;
    }
  }
}

// The A fragments of a k-step from a warp's staged y (row q at y + q *
// kYPitch, 16 columns, zero past the plane), as a_frags_of
template <int R>
__device__ __forceinline__ void plane_a_frags(const float* y, int g, int t, unsigned (&a)[3][4]) {
  auto pair = [&](int row, int col) {
    return *reinterpret_cast<const float2*>(y + row * kYPitch + col);
  };
  float2 v[4];
#pragma unroll
  for (int q = 0; q < (R == 8 ? 4 : 2); ++q)
    v[q] = R == 8 ? pair((q & 1) ? R + g : g, 2 * t + (q >= 2 ? 8 : 0)) : pair(g, 2 * t + 8 * q);
  a_frags_of<R>(v, a);
}

// The B fragments of rows k0 .. k0 + 15 of a staged bf16 run (16-byte rows,
// the imaginary part `im` bytes after the real one): {re b0, re b1, im b0,
// im b1}, by one ldmatrix.x4.trans (lanes 8j .. 8j + 7 address the rows of
// matrix j: re rows k0..k0+7, re k0+8.., im k0.., im k0+8..)
__device__ __forceinline__ void ldsm_b_bf16(const unsigned char* run, int im, int k0, int lane,
                                            unsigned (&b)[4]) {
  const int mat = lane >> 3;
  const unsigned char* p = run + (mat >> 1) * im + (k0 + (mat & 1) * 8 + (lane & 7)) * 16;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// int8 entry byte (two's complement) -> its value as f32, exactly: the byte
// + 128 in the low mantissa bits of 2^23, less 2^23 + 128
__device__ __forceinline__ unsigned s8_as_f32_bits(unsigned byte) {
  return __float_as_uint(__uint_as_float(0x4B000000u | (byte ^ 0x80u)) - 8388736.f);
}

// bf16x2 of two int8 entries (|q| <= 127 keeps 7 bits: the f32's upper
// halves are exact), lo in the low half
__device__ __forceinline__ unsigned s8x2_as_bf16x2(unsigned lo, unsigned hi) {
  return __byte_perm(s8_as_f32_bits(lo), s8_as_f32_bits(hi), 0x7632);
}

// The same fragments of a staged int8 run (8-byte rows): lane (g, t) reads
// rows k0 + 2t, + 1, + 8, + 9 of output lane g, a byte each
__device__ __forceinline__ void lds_b_int8(const unsigned char* run, int im, int k0, int g,
                                           int t, unsigned (&b)[4]) {
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const unsigned char* p = run + part * im + (k0 + 2 * t) * kLanes + g;
    b[2 * part] = s8x2_as_bf16x2(p[0], p[kLanes]);
    b[2 * part + 1] = s8x2_as_bf16x2(p[8 * kLanes], p[9 * kLanes]);
  }
}

// One k-step of one tile: the products of the A fragments with the tile's
// B fragments on fresh sums (the small terms first), folded to a lane's
// values: R = 8, e1 = Y . Pre and e2 = Y . Pim as m16n8k16 accumulators (rows
// g, 8 + g); R = 4, e[0..1] row g's values at output lanes 2t, 2t + 1 (the
// two row halves added), e[2..3] zero
template <int R>
__device__ __forceinline__ void plane_kstep(const unsigned (&a)[3][4], const unsigned (&b)[4],
                                            float (&e1)[4], float (&e2)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) e1[q] = e2[q] = 0.f;
  if constexpr (R == 8) {
#pragma unroll
    for (int term = 2; term >= 0; --term) {
      mma16816(e1, a[term], b[0], b[1]);
      mma16816(e2, a[term], b[2], b[3]);
    }
  } else {
    mma16816(e1, a[1], b[0], b[1]);
    mma16816(e2, a[1], b[2], b[3]);
    mma16816(e1, a[0], b[0], b[1]);
    mma16816(e2, a[0], b[2], b[3]);
    e1[0] += e1[2];
    e1[1] += e1[3];
    e2[0] += e2[2];
    e2[1] += e2[3];
  }
}

// A lane's part of a tile's 2R x 8 values (value v = row * 8 + lane at
// part[v * pitch]) from its sums z1 = Y . Pre, z2 = Y . Pim: R = 8, t_re of
// right-hand side g = z1[g] - z2[8 + g], t_im = z1[8 + g] + z2[g]
// (lane-local); R = 4 lane (g, t) holds y row g (re_g for g < 4, im_{g-4}
// above), whose partner row is four lanes of g away (lane ^ 16)
template <int R>
__device__ __forceinline__ void plane_store_part(const float (&z1)[4], const float (&z2)[4],
                                                 float* part, int pitch) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (R == 8) {
    const int re = g * kLanes + 2 * t, imv = (R + g) * kLanes + 2 * t;
    part[re * pitch] = z1[0] - z2[2];
    part[(re + 1) * pitch] = z1[1] - z2[3];
    part[imv * pitch] = z1[2] + z2[0];
    part[(imv + 1) * pitch] = z1[3] + z2[1];
  } else {
    // row g = p (re_p, g < 4) or R + p (im_p): t_re = Yr.Pre - Yi.Pim,
    // t_im = Yi.Pre + Yr.Pim
    const float o0 = __shfl_xor_sync(0xffffffffu, z2[0], 16);
    const float o1 = __shfl_xor_sync(0xffffffffu, z2[1], 16);
    const int v = g * kLanes + 2 * t;
    part[v * pitch] = g < R ? z1[0] - o0 : z1[0] + o0;
    part[(v + 1) * pitch] = g < R ? z1[1] - o1 : z1[1] + o1;
  }
}

// r = 16: a lane's part of a tile's 32 x 8 values from the sums of the two
// m16 tiles, tile h holding right-hand sides 8h .. 8h + 7 as R = 8 holds its
// eight (re_p in fragment row p, im_p in row 8 + p): the stacked row of re_p
// is p, of im_p 16 + p
__device__ __forceinline__ void plane_store_part16(const float (&z1)[2][4],
                                                   const float (&z2)[2][4], float* part,
                                                   int pitch) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int re = (8 * h + g) * kLanes + 2 * t, imv = (16 + 8 * h + g) * kLanes + 2 * t;
    part[re * pitch] = z1[h][0] - z2[h][2];
    part[(re + 1) * pitch] = z1[h][1] - z2[h][3];
    part[imv * pitch] = z1[h][2] + z2[h][0];
    part[(imv + 1) * pitch] = z1[h][3] + z2[h][1];
  }
}

}  // namespace wide
