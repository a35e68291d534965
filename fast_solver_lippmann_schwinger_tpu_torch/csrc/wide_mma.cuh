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

// ---------------------------------------------------------------------------
// The plane kernels' step at r = 4 and 8 (plane_pass.cuh, note 4).  The line
// kernels above do not use what follows.
//
// A warp splits the 16 columns of a k-step of y once and multiplies them into
// every tile of its CTA (or block); the B fragments come whole from shared
// memory: bf16 runs by ldmatrix.trans (the 16-byte rows of a run are 8 x 8
// core matrices), int8 runs a byte an entry, widened by a byte permute and a
// subtraction (no conversion instruction).  M holds the 2r stacked rows: at
// r = 8 re_p in fragment row p and im_p in row 8 + p, as above; at r = 4,
// whose 8 rows fill half of M, rows 0-7 take the h term of the y rows and
// rows 8-15 their m term, a second product the l term (two products a part
// instead of three), and a lane adds its two row halves.
// ---------------------------------------------------------------------------

// y rows of a k-step staged by a warp: 2R rows of 16 columns at a pitch of 24
// floats (the fragment loads of a half-warp meet no bank twice)
constexpr int kYPitch = 24;

// The A fragments of a k-step from a warp's staged y (row q at y + q *
// kYPitch, 16 columns, zero past the plane).  R = 8: the three terms of rows
// g (re_g) and 8 + g (im_g).  R = 4: a[0] = {h, m} of row g (fragment rows g
// and 8 + g), a[1] = {l, 0}; a[2] unused.
template <int R>
__device__ __forceinline__ void plane_a_frags(const float* y, int g, int t, unsigned (&a)[3][4]) {
  auto pair = [&](int row, int col) {
    return *reinterpret_cast<const float2*>(y + row * kYPitch + col);
  };
  if constexpr (R == 8) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = pair((q & 1) ? R + g : g, 2 * t + (q >= 2 ? 8 : 0));
      split3(v.x, v.y, a[0][q], a[1][q], a[2][q]);
    }
  } else {
    static_assert(R == 4, "wide plane step: r = 4 or 8");
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 v = pair(g, 2 * t + 8 * q);
      unsigned h, m, l;
      split3(v.x, v.y, h, m, l);
      a[0][2 * q] = h;
      a[0][2 * q + 1] = m;
      a[1][2 * q] = l;
      a[1][2 * q + 1] = 0u;
    }
  }
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
// part[v * pitch]) from its sums z1 = Y . Pre, z2 = Y . Pim: R = 8 as
// store_part; R = 4 lane (g, t) holds y row g (re_g for g < 4, im_{g-4}
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

}  // namespace wide
