// Whole Gauss-Seidel sweep directions on banded+tail pivots, on Hopper (sm_90a).
//
// Replaces the two TPU kernels of the JAX package's sparse/pallas_sweep.py,
// launched by _sweep_fused for gs_sweep_fused:
//
//   sweep::down_kernel<R>  (_down_kernel)  the DOWN sweep.  For each slab s in
//     order: the forward pass over its m lines, with the equivalent sources of
//     the slab above injected at its top trace lines,
//         line l0 (has_top):  + C01 . u_np(s-1),    line l1:  - C10 . u_n(s-1),
//     keeping the y and t stacks; then the backward pass over its last tt lines
//     (x_m = 0), which yields its bottom traces u_n (line ln) and u_np (line
//     lnp, also an output: the up sweep's reflection correction needs it).
//   sweep::up_kernel<R>    (_up_kernel)    the UP sweep.  For each slab in
//     reverse: the forward pass resumed at line j0 = m - tt from the down
//     sweep's carry t[s, j0-1], with the traces of the slab below injected at
//     its bottom trace lines,
//         line lnp (has_bot): + Cnpn . u_0(s+1),    line ln:  - Cnnp . u_1(s+1),
//     then the full backward pass, which writes the slab's volume solution u
//     (lines < j0 read the down sweep's y stack, the rest this pass's own) and
//     yields its top traces u_0 (line l0) and u_1 = x(l1) - u_np(s-1) (line l1).
//
// This is precondGSOptimized (src/preconditioner.jl:557-630) with every local
// solve and all the trace algebra between slabs in one launch per direction:
// no host round trip and no kernel boundary between slabs.  On the TPU the
// traces and the tail of the y stack live in VMEM scratch; here they are
// (2r, ld) rows in global memory (`scratch`), L2-resident, written by the tiles
// that own their lanes and read by every block after the grid barrier that
// orders them.  At slab 0 (down) and slab S-1 (up) the flags keep every trace
// read away, so the scratch needs no zeroing.
//
// Design.  Each kernel is a step map over the line step of thomas_line.cuh
// (run_steps, with the injection enabled): one step per (slab, line phase),
// S x (m + tt) steps, one grid barrier after each, so a launch at the 801^2
// headline (S = 16, m = 70, tt = 22) is 1472 line steps.  The metadata
// (6, S) = [l0, l1, ln, lnp, has_top, has_bot] decide per step whether an
// injection or a trace copy happens: the flag, not the line index, is the
// predicate (absent lines are stored as 0).  Every operand is staged one item
// ahead (see thomas_line.cuh) but the carry, the traces and the y row of a
// backward pass's first line, which the step just before wrote: those are read
// after the barrier.  (The y row of any later backward line was written two or
// more barriers before its copy is issued.)
//
// Limits.  r = 1 or 2; the slab count of the rows is the factorization's
// (slab s uses planes s); 0 < tt < m; n up to about 1300 at r = 2.  Anything
// else is refused with cudaErrorInvalidValue before a launch.
//
// Bound: bytes.  Per slab, the forward pass streams every line's planes and
// the backward pass those of its tt lines, head windows (2 x ld x (8 + 2 half)
// x 2 B) or dense planes (2 x ld^2 x 2 B): 2.48 GB per launch at the headline,
// 0.74 ms at 3.35 TB/s.
//
// sweep_fused launches only (up = 0: the down kernel; 1: the up kernel); it
// allocates nothing, does not synchronise, and returns the launch's error code
// (0 on success).
#include "thomas_line.cuh"

namespace sweep {

using thomas::Cols;
using thomas::kLanes;
using thomas::Tile;

struct SweepArgs {
  const float* b;          // (S, m, 2r, ld) right-hand rows
  const float* lband;      // (S, m, 2, 3, ld)
  const float* uband;      // (S, m, 2, 3, ld)
  const uint16_t* hre;     // (S, tail_start, ld/8, 8 + 2 half, 8) head windows
  const uint16_t* him;
  const uint16_t* tre;     // (S, m - tail_start, ld/8, ld, 8) tail planes
  const uint16_t* tim;
  const int* meta;         // (6, S) int32: l0, l1, ln, lnp, has_top, has_bot
  const float* cpl_a;      // (S, 2, 3, ld): down C01, up Cnpn
  const float* cpl_b;      // (S, 2, 3, ld): down C10, up Cnnp
  float* y;                // (S, m, 2r, ld) y stack: down writes, up reads
  float* t;                // (S, m, 2r, ld) t stack: down writes, up reads line j0-1
  float* unp;              // (S, 2r, ld) bottom traces u_np: down writes (zero
                           //   beforehand), up reads
  float* u;                // (S, m, 2r, ld) volume solution: up writes
  float* scratch;          // down: (tt + 1) rows; up: (2 tt + 2) rows of (2r, ld)
  int S, m, n, ld, tail_start, half, tt;
};

template <int R>
struct DownItems {
  SweepArgs a;
  int tiles_blk;

  __device__ __forceinline__ Tile tile(int q) const {
    const int k = q / tiles_blk;
    const int t = blockIdx.x + (q - k * tiles_blk) * gridDim.x;
    const int per = a.m + a.tt;
    const int s = k / per, g = k - s * per;
    const size_t row = (size_t)2 * R * a.ld;
    float* xt = a.scratch;                   // backward carry, line m-1-k at row k
    float* un = a.scratch + a.tt * row;      // u_n of the slab above
    const int* meta = a.meta;
    Tile tl = thomas::plain_tile(t * kLanes, k);
    const int j = g < a.m ? g : a.m - 1 - (g - a.m);
    tl.cols = thomas::tile_cols(a.tre, a.tim, a.hre, a.him, s, j, t, a.m, a.n, a.ld,
                                a.tail_start, a.half);
    const size_t at = (size_t)s * a.m + j;
    if (g < a.m) {           // forward pass with the top injections
      tl.band = a.lband + at * 6 * a.ld;
      tl.rhs = a.b + at * row;
      tl.prev = j > 0 ? a.t + (at - 1) * row : nullptr;
      tl.kept = a.y + at * row;
      tl.out = a.t + at * row;
      if (__ldg(meta + 4 * a.S + s) != 0) {
        if (j == __ldg(meta + s)) {
          tl.cpl = a.cpl_a + (size_t)s * 6 * a.ld;
          tl.trace = a.unp + (size_t)(s - 1) * row;
        } else if (j == __ldg(meta + a.S + s)) {
          tl.cpl = a.cpl_b + (size_t)s * 6 * a.ld;
          tl.trace = un;
          tl.sign = -1.f;
        }
      }
    } else {                 // backward pass over the last tt lines
      const int kk = g - a.m;
      tl.band = a.uband + at * 6 * a.ld;
      tl.rhs = a.y + at * row;
      tl.rhs_late = kk == 0;                 // y of line m-1: written in the step before
      tl.prev = kk > 0 ? xt + (size_t)(kk - 1) * row : nullptr;
      tl.out = xt + (size_t)kk * row;
      if (__ldg(meta + 5 * a.S + s) != 0) {
        if (j == __ldg(meta + 2 * a.S + s))
          tl.out2 = un;
        else if (j == __ldg(meta + 3 * a.S + s))
          tl.out2 = a.unp + (size_t)s * row;
      }
    }
    return tl;
  }
};

template <int R>
struct UpItems {
  SweepArgs a;
  int tiles_blk;

  __device__ __forceinline__ Tile tile(int q) const {
    const int k = q / tiles_blk;
    const int t = blockIdx.x + (q - k * tiles_blk) * gridDim.x;
    const int per = a.tt + a.m;
    const int i = k / per, g = k - i * per;
    const int s = a.S - 1 - i;               // slabs in reverse
    const int j0 = a.m - a.tt;
    const size_t row = (size_t)2 * R * a.ld;
    float* ytail = a.scratch;                // y of lines j0.. of this pass
    float* tstk = ytail + a.tt * row;        // its carry
    float* u0 = tstk + a.tt * row;           // u_0 and u_1 of the slab below
    float* u1 = u0 + row;
    const int* meta = a.meta;
    Tile tl = thomas::plain_tile(t * kLanes, k);
    const int j = g < a.tt ? j0 + g : a.m - 1 - (g - a.tt);
    tl.cols = thomas::tile_cols(a.tre, a.tim, a.hre, a.him, s, j, t, a.m, a.n, a.ld,
                                a.tail_start, a.half);
    const size_t at = (size_t)s * a.m + j;
    if (g < a.tt) {          // forward pass resumed at j0, bottom injections
      tl.band = a.lband + at * 6 * a.ld;
      tl.rhs = a.b + at * row;
      tl.prev = g > 0 ? tstk + (size_t)(g - 1) * row : a.t + ((size_t)s * a.m + j0 - 1) * row;
      tl.kept = ytail + (size_t)g * row;
      tl.out = tstk + (size_t)g * row;
      if (__ldg(meta + 5 * a.S + s) != 0) {
        if (j == __ldg(meta + 3 * a.S + s)) {
          tl.cpl = a.cpl_a + (size_t)s * 6 * a.ld;
          tl.trace = u0;
        } else if (j == __ldg(meta + 2 * a.S + s)) {
          tl.cpl = a.cpl_b + (size_t)s * 6 * a.ld;
          tl.trace = u1;
          tl.sign = -1.f;
        }
      }
    } else {                 // full backward pass: the volume and the top traces
      tl.band = a.uband + at * 6 * a.ld;
      if (j >= j0) {
        tl.rhs = ytail + (size_t)(j - j0) * row;
        tl.rhs_late = j == a.m - 1;          // written in the step before
      } else {
        tl.rhs = a.y + at * row;             // the down launch's: staged ahead
      }
      tl.prev = j < a.m - 1 ? a.u + (at + 1) * row : nullptr;
      tl.out = a.u + at * row;
      if (__ldg(meta + 4 * a.S + s) != 0) {
        if (j == __ldg(meta + s)) {
          tl.out2 = u0;
        } else if (j == __ldg(meta + a.S + s)) {
          tl.out2 = u1;                      // reflection correction
          tl.sub2 = a.unp + (size_t)(s - 1) * row;
        }
      }
    }
    return tl;
  }
};

template <int R>
__global__ void __launch_bounds__(thomas::kThreads) down_kernel(const SweepArgs a) {
  const int tiles = a.ld / kLanes;
  const int tiles_blk = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const DownItems<R> items{a, tiles_blk};
  thomas::run_steps<R, true>(items, a.S * (a.m + a.tt) * tiles_blk, a.n, a.ld);
}

template <int R>
__global__ void __launch_bounds__(thomas::kThreads) up_kernel(const SweepArgs a) {
  const int tiles = a.ld / kLanes;
  const int tiles_blk = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const UpItems<R> items{a, tiles_blk};
  thomas::run_steps<R, true>(items, a.S * (a.tt + a.m) * tiles_blk, a.n, a.ld);
}

template <int R>
inline cudaError_t launch(bool up, const SweepArgs& a, cudaStream_t stream) {
  const size_t smem = thomas::smem_bytes<R, true>(a.n, a.ld);
  const int tiles = a.ld / kLanes;
  return up ? thomas::launch_cooperative(up_kernel<R>, a, smem, tiles, stream)
            : thomas::launch_cooperative(down_kernel<R>, a, smem, tiles, stream);
}

}  // namespace sweep

extern "C" int sweep_fused(
    int up, const float* b, const float* lband, const float* uband,
    const uint16_t* hre, const uint16_t* him, const uint16_t* tre, const uint16_t* tim,
    const int* meta, const float* cpl_a, const float* cpl_b,
    float* y, float* t, float* unp, float* u, float* scratch,
    int S, int m, int n, int ld, int r, int tail_start, int half, int tt, void* stream) {
  if (S < 1 || m < 2 || n < 1 || ld < n || ld % thomas::kLanes != 0 || r < 1 || r > thomas::kMaxRhs ||
      tt < 1 || tt >= m || tail_start < 1 || tail_start >= m || half < 0)
    return (int)cudaErrorInvalidValue;
  sweep::SweepArgs a{};
  a.b = b;
  a.lband = lband;
  a.uband = uband;
  a.hre = hre;
  a.him = him;
  a.tre = tre;
  a.tim = tim;
  a.meta = meta;
  a.cpl_a = cpl_a;
  a.cpl_b = cpl_b;
  a.y = y;
  a.t = t;
  a.unp = unp;
  a.u = u;
  a.scratch = scratch;
  a.S = S;
  a.m = m;
  a.n = n;
  a.ld = ld;
  a.tail_start = tail_start;
  a.half = half;
  a.tt = tt;
  cudaError_t err = r == 1 ? sweep::launch<1>(up != 0, a, (cudaStream_t)stream)
                           : sweep::launch<2>(up != 0, a, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
