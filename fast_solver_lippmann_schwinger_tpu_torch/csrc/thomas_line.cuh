// Block-Thomas substitution pass: the body of the three substitution kernels
//
//     pass_kernel<R, false, false>   forward pass           thomas_fwd.cu
//     pass_kernel<R, true,  false>   backward pass          thomas_bwd.cu
//     pass_kernel<R, false, true>    cached forward pass    thomas_fwd_cached.cu
//
// which those files instantiate and launch.  The passes differ only in the
// order of the lines and in where the carry comes from and goes to, so they
// share this one body; direction and caching are template parameters, so that
// each is a kernel of its own (and has its own name in a profiler's trace).
//
// Per line j and batch row b (slab s = s_idx[b]) a pass computes
//
//     w = rhs_j - band_j . prev          complex 3-tap band, re/im rows
//     t = C_j^{-1} w                     [Wr; Wi] @ Cinv^T, bf16 planes
//
// where prev is the t of the line before (forward: j-1, backward: j+1).  At
// the pass's first line prev is zero, except in the cached forward pass,
// which takes it from the caller (t_init) and so can resume a pass that an
// earlier launch left off.  The cached pass also keeps every t_j: its t stack
// is both an output and the place the carry lives in, as the x stack is for
// the backward pass.  Numerics contract of the JAX package's
// Pallas kernels (sparse/pallas_thomas.py: _band_apply_multi,
// _pivot_dot_multi): bf16 pivot planes widened to f32, f32 multiply-add and
// accumulation, f32 carries and bands, complex arithmetic as separate re/im
// rows stacked [re_0..re_{r-1}; im_0..im_{r-1}].
//
// Work split within a line.  A tile is kLanes = 8 output lanes of one batch
// row, and its block loops over ALL input rows: no reduction across blocks.
// Pivots are stored transposed and tile-major, cinv_t[s, j, t, i_in, l] =
// Cinv^T[i_in, 8 t + l], so a tile's 16-byte runs (one per input row) lie
// back to back and a warp's copies coalesce into whole cache lines.
// w (2r x n floats) is small; every block recomputes all of it into shared
// memory from the previous carry in global memory (lanes o-1, o, o+1, zero
// outside [0, n)).  Threads stride over the input rows, each keeping 2r x 8
// partial sums, and the block reduces them with warp shuffles and one pass
// through shared memory.
//
// Ordering of the lines.  Line j needs the COMPLETE t of the line before.
// The TPU runs its (slab, line) grid in order on one core; here the whole
// pass is ONE COOPERATIVE LAUNCH whose blocks stay resident and meet at
// cooperative_groups::this_grid().sync() once per line.  The grid is sized
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor so that every block is
// co-resident (a launch that does not fit is refused with an error, it does
// not hang); a block takes several tiles per line when there are more tiles
// than resident blocks.
//
// What is on the critical path.  Between two barriers only the carry is new;
// a line's plane columns, band and right-hand rows do not depend on it.  So
// they are copied into shared memory with cp.async one work item AHEAD,
// while the block still computes and waits at the barrier, and after the
// barrier a block issues one batch of loads (the carry, 2r x ld floats, read
// past the incoherent L1), forms w out of shared memory, multiplies, reduces
// and stores.  Measured on an H100 at n = 801: with every operand loaded
// where it is used, the dependent L2 round trips of the band step alone cost
// 8.6 us per line, against 1 us for the barrier and 0.4 us for the products.
//
// Limits.  r = 1 or 2 right-hand sides per launch, and a line whose rows and
// plane buffers fit in one block's shared memory (64 n bytes of planes plus
// the rows: n up to about 1700 at r = 2 on an H100).  Anything else is
// refused with cudaErrorInvalidValue before a launch.
//
// Bound: bytes.  A line must read its two planes once, 2 x ld^2 x 2 B
// (2.6 MB at n = 801, ld = 808), which the card's 3.35 TB/s moves in
// 0.78 us; the arithmetic (2 x 2r x 2 x ld^2 flop) is far below the f32
// rate.  Each plane byte is read exactly once per pass and serves all r
// right-hand sides.
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

struct PassArgs {
  const float* rhs;        // (B, m, 2r, ld) right-hand rows of the pass
  const float* band;       // (S, m, 2, 3, ld) [re, im] x tap x lane
  const uint16_t* cre;     // (S, m, ld/8, ld, 8) bf16 bits, tile-major
  const uint16_t* cim;     //   transposed pivot, real and imaginary plane
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
};

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

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// One work item of a block: tile (batch row b, lanes o0..o0+7) of line j.
struct Item {
  int j, b, o0;
  size_t plane;            // offset of this tile's (ld, 8) block in cre/cim
};

template <bool kBackward>
__device__ __forceinline__ Item item_at(const PassArgs& a, int q, int tiles_blk,
                                        int tiles_row) {
  Item it;
  const int k = q / tiles_blk;
  const int tile = blockIdx.x + (q - k * tiles_blk) * gridDim.x;
  it.j = kBackward ? a.first - k : a.first + k;
  it.b = tile / tiles_row;
  const int t = tile - it.b * tiles_row;
  it.o0 = t * kLanes;
  it.plane = (((size_t)a.s_idx[it.b] * a.m + it.j) * tiles_row + t) * a.ld * kLanes;
  return it;
}

// Shared memory of one block: the plane buffers (two buffers x two planes x
// n rows of 16 bytes), then float rows.  Rows are ld floats wide; the carry
// rows have 4 zero floats on either side so that lanes -1 and ld read as zero
// and float4 stores stay aligned.
template <int R>
__host__ __device__ constexpr size_t smem_bytes(int n, int ld) {
  return (size_t)64 * n +
         sizeof(float) * ((size_t)(6 + 2 * 2 * R) * ld + (size_t)2 * R * (ld + 8) +
                          kWarps * 2 * R * kLanes);
}

// R = number of right-hand sides r (rows are 2R); kBackward = bottom-up pass;
// kCached = forward pass that starts from t_init and keeps the t stack.
template <int R, bool kBackward, bool kCached>
__global__ void __launch_bounds__(kThreads) pass_kernel(const PassArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, ld = a.ld, ldp = ld + 8;
  // staged[buf][plane][row]: one uint4 (8 bf16 lanes) per input row
  uint4* staged = reinterpret_cast<uint4*>(smem_raw);
  float* s_band = reinterpret_cast<float*>(smem_raw + (size_t)64 * n);
  float* s_rhs = s_band + 6 * ld;           // [2R][ld]
  float* w = s_rhs + 2 * R * ld;            // [2R][ld]
  float* s_prev = w + 2 * R * ld;           // [2R][4 + ld + 4]
  float* red = s_prev + 2 * R * ldp;        // [kWarps][2R * kLanes]

  const int tid = threadIdx.x;
  const int ld4 = ld / 4;                   // float4 per float row
  const size_t row = (size_t)2 * R * ld;    // floats per (batch row, line)
  const int tiles_row = ld / kLanes;
  const int total = a.batch * tiles_row;
  const int tiles_blk = (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nitem = a.count * tiles_blk;

  auto stage_planes = [&](const Item& it, int buf) {
    if (!kNoPlaneCopies) {
      const uint4* gre = reinterpret_cast<const uint4*>(a.cre + it.plane);
      const uint4* gim = reinterpret_cast<const uint4*>(a.cim + it.plane);
      uint4* sre = staged + (size_t)buf * 2 * n;
      uint4* sim = sre + n;
      for (int i = tid; i < n; i += kThreads) {
        cp_async16(sre + i, gre + i);
        cp_async16(sim + i, gim + i);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto stage_rows = [&](const Item& it) {
    const float* band = a.band + ((size_t)__ldg(a.s_idx + it.b) * a.m + it.j) * 6 * ld;
    const float* rhs = a.rhs + ((size_t)it.b * a.m + it.j) * row;
    if (!kNoRowCopies) {
      for (int i = tid; i < 6 * ld4; i += kThreads) cp_async16(s_band + 4 * i, band + 4 * i);
      for (int i = tid; i < 2 * R * ld4; i += kThreads) cp_async16(s_rhs + 4 * i, rhs + 4 * i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  for (int i = tid; i < 2 * R * 8; i += kThreads)     // zero guards of s_prev
    s_prev[(i / 8) * ldp + (i % 8 < 4 ? i % 8 : ld + i % 8)] = 0.f;

  Item next = item_at<kBackward>(a, 0, tiles_blk, tiles_row);
  stage_planes(next, 0);
  stage_rows(next);

  for (int q = 0; q < nitem; ++q) {
    const Item it = next;
    const bool more = q + 1 < nitem;
    if (more) next = item_at<kBackward>(a, q + 1, tiles_blk, tiles_row);
    const int j = it.j, b = it.b, o0 = it.o0;
    const bool carry_in = (kCached || j != a.first) && !kNoBandStep;
    const float* prev;
    float* t_out;
    if (kBackward) {         // x stack holds lines first-count+1 .. first
      float* x = a.out + ((size_t)b * a.count + (j - (a.first - a.count + 1))) * row;
      t_out = x;
      prev = x + row;
    } else if (kCached) {    // t stack holds lines first .. m-1; t_init before them
      float* t = a.out + ((size_t)b * a.m + j) * row;
      t_out = t;
      prev = j == a.first ? a.t_init + (size_t)b * row : t - row;
    } else {                 // two-slot ping-pong carry
      t_out = a.out + ((size_t)(j & 1) * a.batch + b) * row;
      prev = a.out + ((size_t)((j - 1) & 1) * a.batch + b) * row;
    }

    // 1. the carry: the only operand that the barrier was waiting for.  It
    //    was written by other blocks, so read it past the (incoherent) L1.
    //    All loads of a batch are issued before the first is used.
    if (carry_in && !kNoCarryLoad) {
      for (int base = tid; base < 2 * R * ld4; base += kThreads * kCarryBatch) {
        float4 v[kCarryBatch];
#pragma unroll
        for (int u = 0; u < kCarryBatch; ++u) {
          const int i = base + u * kThreads;
          if (i < 2 * R * ld4) v[u] = __ldcg(reinterpret_cast<const float4*>(prev) + i);
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
          *reinterpret_cast<float4*>(s_prev + qq * ldp + 4 + c) = v[u];
        }
      }
    }
    // this item's planes, band and right-hand rows were requested during the
    // item before: they have landed by now
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // 2. w = rhs - band . prev for every lane, out of shared memory
    for (int i = tid; i < n; i += kThreads) {
      float accr[R], acci[R];
#pragma unroll
      for (int p = 0; p < R; ++p) accr[p] = acci[p] = 0.f;
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
#pragma unroll
      for (int p = 0; p < R; ++p) {
        w[p * ld + i] = s_rhs[p * ld + i] - accr[p];
        w[(R + p) * ld + i] = s_rhs[(R + p) * ld + i] - acci[p];
      }
    }
    __syncthreads();
    if (more) {                      // band and rhs buffers are free again
      stage_rows(next);
      stage_planes(next, (q + 1) & 1);
    }

    // the forward pass keeps w (its y stack); each tile writes its own lanes
    if (!kBackward && tid < 2 * R * kLanes) {
      const int qq = tid / kLanes, o = o0 + tid % kLanes;
      a.kept[((size_t)b * a.m + j) * row + qq * ld + o] = o < n ? w[qq * ld + o] : 0.f;
    }

    // 3. partial products over this thread's input rows, both planes
    float zre[2 * R][kLanes], zim[2 * R][kLanes];
#pragma unroll
    for (int qq = 0; qq < 2 * R; ++qq)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) zre[qq][l] = zim[qq][l] = 0.f;

    const uint4* pre = staged + (size_t)(q & 1) * 2 * n;   // one uint4 per
    const uint4* pim = pre + n;                            //   input row
#pragma unroll 4
    for (int i = tid; i < (kNoProducts ? 0 : n); i += kThreads) {
      const uint4 vr = pre[i];
      const uint4 vi = pim[i];
      float cr[kLanes], ci[kLanes];
      widen_bf16x8(vr, cr);
      widen_bf16x8(vi, ci);
#pragma unroll
      for (int qq = 0; qq < 2 * R; ++qq) {
        const float wq = w[qq * ld + i];
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
      for (int wi = 0; wi < kWarps; ++wi) v += red[wi * 2 * R * kLanes + tid];
      t_out[(tid / kLanes) * ld + o0 + tid % kLanes] = v;
    }

    // every block passes here once per line but the last: all tiles of line
    // j are complete before any block starts the next line
    if (more && next.j != j && !kNoBarrier) cg::this_grid().sync();
  }
}

template <int R, bool kBackward, bool kCached>
inline cudaError_t launch_pass(const PassArgs& a, cudaStream_t stream) {
  auto kernel = pass_kernel<R, kBackward, kCached>;
  const size_t smem = smem_bytes<R>(a.n, a.ld);
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
  const int total = a.batch * (a.ld / kLanes);
  const int grid = total < per_sm * sms ? total : per_sm * sms;
  PassArgs args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kThreads),
                                     params, smem, stream);
}

template <bool kBackward, bool kCached = false>
inline cudaError_t run_pass(int r, const PassArgs& a, cudaStream_t stream) {
  if (a.batch < 1 || a.m < 1 || a.n < 1 || a.ld < a.n || a.ld % kLanes != 0 ||
      r < 1 || r > kMaxRhs || a.count < 1 || a.first < 0 || a.first >= a.m)
    return cudaErrorInvalidValue;
  return r == 1 ? launch_pass<1, kBackward, kCached>(a, stream)
                : launch_pass<2, kBackward, kCached>(a, stream);
}

}  // namespace thomas
