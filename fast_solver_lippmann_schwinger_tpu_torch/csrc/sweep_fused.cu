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
// traces and the tail of the y stack live in VMEM scratch.
//
// Design.  Each kernel is a step map (DownItems, UpItems) over the
// flag-handoff step of thomas_flow.cuh (run_flow, with the injection), which
// describes the step: one step per (slab, line phase), S x (m + tt) steps, so
// a launch at the 801^2 headline (S = 16, m = 70, tt = 22) is 1472 line steps,
// one cooperative launch, one CTA a tile (two on lines too long for one), each
// step's carry handed on through flagged words of the exchange buffer `xchg`,
// one slot per step and flag epoch + step, with no grid barrier.  The metadata
// (6, S) = [l0, l1, ln, lnp, has_top, has_bot] decide per step whether an
// injection or a trace store happens: the flag, not the line index, is the
// predicate (absent lines are stored as 0).  What crosses steps:
//   - the traces: a trace is the t of a backward line, so the injection of
//     the next slab reads the words of that backward step (slot and flag of
//     that step), less u_np of the slab for the up sweep's reflection
//     correction u_1 = x(l1) - u_np; the down kernel also stores u_np, the up
//     kernel's input;
//   - y of a backward line: the w that the same CTA formed for its own rows
//     at the forward step of that line (lines >= m - tt of this launch), kept
//     in the CTA's private lines of `scratch`; the up kernel's lines < j0 read
//     the down launch's y stack, staged ahead like the other operands;
//   - the up kernel's first forward line takes its carry from the down
//     launch's t stack at line j0 - 1, a plain load.
// So a step waits only on the words of earlier steps, never on a row another
// CTA stored.  At slab 0 (down) and slab S-1 (up) the flags keep every trace
// read away.
//
// Wide batches (r = 4, 8, 16).  The same maps drive the wide step of
// thomas_flow.cuh (run_wide; note "Wide batches on banded+tail pivots"),
// which hands the next line's pre-added w over instead of t, on a ring of
// four slots of the rows buffer `rows`: a trace is then a row that the
// publisher of each tile stores at the backward step that makes it (the down
// kernel's u_np into unp and u_n into `u`, which it does not otherwise use;
// the up kernel's u_0 and u_1 are lines of its volume u), and the publisher
// of the step before the injected line adds the coupling band's taps on it,
// as it adds the band's on t; y of a backward line is the CTA's own w of the
// forward step, kept in its private lines of `scratch` (the tile's lanes read
// back by the publisher, the slice's by a step without a carry).
//
// Limits.  r = 1, 2, 4, 8 or 16; the slab count of the rows is the
// factorization's (slab s uses planes s); 0 < tt < m; lines as the
// flag-handoff step with the trace rows beside the carry at r <= 2 (one CTA a
// tile up to n = 912 at r = 2, two up to 1840), as the dense passes' wide step
// at r = 4, 8, 16 (thomas_flow.cuh, note "Limits"; test_longest_line_fits).
// Anything else is refused with cudaErrorInvalidValue before a launch.
//
// Bound: bytes, as chip_smoke.py:ht_sweep_bound computes it: each input read
// once and each output written once.  Every line's pivots once (head windows,
// 2 x ld x (8 + 2 half) x 2 B less the rows outside [0, n), or dense planes, 2
// x n x ld x 2 B; the backward pass's tail lines are not counted again), the
// bands of the forward and backward lines, the rows in and out, and the
// traces: 1.57 GB, 0.468 ms at 3.35 TB/s for the down kernel at the headline,
// r = 1.
//
// sweep_fused launches only (up = 0: the down kernel; 1: the up kernel); it
// allocates nothing, does not synchronise, and returns the launch's error code
// (0 on success).
#include "thomas_flow.cuh"

namespace sweep {

using thomas::kLanes;

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
  float* u;                // (S, m, 2r, ld) volume solution: up writes; r = 4, 8, 16, down:
                           //   (S, 2r, ld) bottom traces u_n, which it writes
  float* scratch;          // the CTAs' private y lines: tt lines of each CTA's slice
                           //   rows, ld / 8 x tt x 2r x (ld + 8) floats at most
  float* rows;             // r = 4, 8, 16: the wide step's rows, kSlots x wide_slot_bytes
  int S, m, n, ld, tail_start, half, tt;
};

using thomas::FlowTile;

// Slab s's line of meta row `row` (l0, l1, ln, lnp, has_top, has_bot)
__device__ __forceinline__ int meta_of(const SweepArgs& a, int row, int s) {
  return __ldg(a.meta + row * a.S + s);
}

// The down sweep as a step map: slab s, step g < m is forward line g, then
// step m + kk is backward line m - 1 - kk, kk < tt
template <int R>
struct DownItems {
  static constexpr bool kWindows = true;         // head windows (run_wide)
  SweepArgs a;
  thomas::FlowLaunch fl;

  __device__ __forceinline__ FlowTile tile(int k, int, int t) const {
    const int per = a.m + a.tt;
    const int s = k / per, g = k - s * per;
    const int jt = a.m - a.tt;                  // first line of the backward pass
    const size_t row = (size_t)2 * R * a.ld;
    const int j = g < a.m ? g : a.m - 1 - (g - a.m);
    FlowTile ft = thomas::flow_tile();
    ft.cols = thomas::tile_cols(a.tre, a.tim, a.hre, a.him, s, j, t, a.m, a.n, a.ld,
                                a.tail_start, a.half);
    const size_t at = (size_t)s * a.m + j;
    if (g < a.m) {           // forward pass with the top injections
      if (j > 0) {
        ft.band = a.lband + at * 6 * a.ld;
        ft.carry_step = k - 1;
      }
      ft.rhs = a.b + at * row;
      ft.kept = a.y + at * row;
      ft.out = a.t + at * row;
      if (j >= jt) ft.keep_priv = j - jt;
      // + C01 . u_np(s-1) at l0, - C10 . u_n(s-1) at l1: the words of the
      // backward steps of slab s - 1 at its lines lnp and ln
      if (s > 0 && meta_of(a, 4, s) != 0 && meta_of(a, 5, s - 1) != 0) {
        const bool top = j == meta_of(a, 0, s);
        const int src = top ? meta_of(a, 3, s - 1)
                            : j == meta_of(a, 1, s) ? meta_of(a, 2, s - 1) : -1;
        if (src >= jt && src < a.m) {
          ft.cpl = (top ? a.cpl_a : a.cpl_b) + (size_t)s * 6 * a.ld;
          ft.trace_step = (s - 1) * per + a.m + (a.m - 1 - src);
          ft.trace_row = (top ? a.unp : a.u) + (size_t)(s - 1) * row;
          ft.sign = top ? 1.f : -1.f;
        }
      }
    } else {                 // backward pass over the last tt lines
      ft.rhs_priv = j - jt;                     // y: this CTA's own w of line j
      if (g > a.m) {
        ft.band = a.uband + at * 6 * a.ld;
        ft.carry_step = k - 1;
      }
      if (meta_of(a, 5, s) != 0 && j == meta_of(a, 3, s))
        ft.out = a.unp + (size_t)s * row;
      else if (thomas::wide<R>() && meta_of(a, 5, s) != 0 && j == meta_of(a, 2, s))
        ft.out = a.u + (size_t)s * row;         // u_n, the wide step's trace row
    }
    return ft;
  }
};

// The up sweep as a step map: slabs in reverse, step g < tt is forward line
// j0 + g (j0 = m - tt), then step tt + kk is backward line m - 1 - kk, kk < m
template <int R>
struct UpItems {
  static constexpr bool kWindows = true;         // head windows (run_wide)
  SweepArgs a;
  thomas::FlowLaunch fl;

  __device__ __forceinline__ FlowTile tile(int k, int, int t) const {
    const int per = a.tt + a.m;
    const int i = k / per, g = k - i * per;
    const int s = a.S - 1 - i;                  // slabs in reverse
    const int j0 = a.m - a.tt;
    const size_t row = (size_t)2 * R * a.ld;
    const int j = g < a.tt ? j0 + g : a.m - 1 - (g - a.tt);
    FlowTile ft = thomas::flow_tile();
    ft.cols = thomas::tile_cols(a.tre, a.tim, a.hre, a.him, s, j, t, a.m, a.n, a.ld,
                                a.tail_start, a.half);
    const size_t at = (size_t)s * a.m + j;
    if (g < a.tt) {          // forward pass resumed at j0, bottom injections
      ft.band = a.lband + at * 6 * a.ld;
      if (g > 0)
        ft.carry_step = k - 1;
      else                   // the down launch's carry
        ft.carry_row = a.t + ((size_t)s * a.m + j0 - 1) * row;
      ft.rhs = a.b + at * row;
      ft.keep_priv = g;
      // + Cnpn . u_0(s+1) at lnp, - Cnnp . (u_1(s+1) - u_np(s)) at ln: the
      // words of the backward steps of slab s + 1 at its lines l0 and l1
      if (s + 1 < a.S && meta_of(a, 5, s) != 0 && meta_of(a, 4, s + 1) != 0) {
        const bool first = j == meta_of(a, 3, s);
        const int src = first ? meta_of(a, 0, s + 1)
                              : j == meta_of(a, 2, s) ? meta_of(a, 1, s + 1) : -1;
        if (src >= 0 && src < a.m) {
          ft.cpl = (first ? a.cpl_a : a.cpl_b) + (size_t)s * 6 * a.ld;
          ft.trace_step = (i - 1) * per + a.tt + (a.m - 1 - src);
          ft.trace_row = a.u + ((size_t)(s + 1) * a.m + src) * row;   // its volume line
          if (!first) {
            ft.trace_sub = a.unp + (size_t)s * row;   // reflection correction
            ft.sign = -1.f;
          }
        }
      }
    } else {                 // full backward pass: the volume
      if (j >= j0)
        ft.rhs_priv = j - j0;                   // this CTA's own w of line j
      else
        ft.rhs = a.y + at * row;                // the down launch's: staged ahead
      if (j < a.m - 1) {
        ft.band = a.uband + at * 6 * a.ld;
        ft.carry_step = k - 1;
      }
      ft.out = a.u + at * row;
    }
    return ft;
  }
};

template <int R, int SPLIT>
__global__ void __launch_bounds__(thomas::flow_threads<SPLIT>(), 512 / thomas::flow_threads<SPLIT>())
    down_kernel(const DownItems<R> items) {
  thomas::run_flow<R, thomas::Storage::kBf16, SPLIT, true>(items, items.fl);
}

template <int R, int SPLIT>
__global__ void __launch_bounds__(thomas::flow_threads<SPLIT>(), 512 / thomas::flow_threads<SPLIT>())
    up_kernel(const UpItems<R> items) {
  thomas::run_flow<R, thomas::Storage::kBf16, SPLIT, true>(items, items.fl);
}

// the narrow step: one exchange slot per step (the traces are words of the
// backward steps); the wide step: a ring of kSlots slots of words and rows
template <int R>
inline cudaError_t launch(bool up, const SweepArgs& a, uint2* xchg, unsigned epoch,
                          cudaStream_t stream) {
  const thomas::FlowLaunch fl{a.S * (a.m + a.tt), 1, a.n, a.ld, xchg, epoch, a.scratch, a.tt,
                              thomas::wide<R>() ? thomas::kSlots : 0, a.rows};
  const int tiles = a.ld / kLanes;
  constexpr auto kBf16 = thomas::Storage::kBf16;
  if (up)
    return thomas::launch_map<R, kBf16, true, UpItems<R>>(up_kernel<R, 1>, up_kernel<R, 2>,
                                                          UpItems<R>{a, fl}, tiles, stream);
  return thomas::launch_map<R, kBf16, true, DownItems<R>>(down_kernel<R, 1>, down_kernel<R, 2>,
                                                          DownItems<R>{a, fl}, tiles, stream);
}

}  // namespace sweep

extern "C" int sweep_fused(
    int up, const float* b, const float* lband, const float* uband,
    const uint16_t* hre, const uint16_t* him, const uint16_t* tre, const uint16_t* tim,
    const int* meta, const float* cpl_a, const float* cpl_b,
    float* y, float* t, float* unp, float* u, float* scratch,
    float* rows,             // r = 4, 8, 16: the wide step's rows (kSlots slots); else null
    int S, int m, int n, int ld, int r, int tail_start, int half, int tt,
    void* xchg,              // exchange words of 8 bytes, zeroed once: r = 1, 2 (S (m + tt),
                             //   1, ld, 2r, 2), r >= 4 (kSlots, 1, ld, 2r, 2)
    unsigned epoch,          // flag of the first step: steps take epoch .. + S (m + tt) - 1
    void* stream) {
  if (S < 1 || m < 2 || n < 1 || ld < n || ld % thomas::kLanes != 0 ||
      !thomas::launch_width(r) || tt < 1 || tt >= m || tail_start < 1 || tail_start >= m ||
      half < 0 || xchg == nullptr || epoch == 0u ||
      epoch + (unsigned)(S * (m + tt)) < epoch ||
      (r > 2 && (rows == nullptr || u == nullptr)))
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
  a.rows = rows;
  a.S = S;
  a.m = m;
  a.n = n;
  a.ld = ld;
  a.tail_start = tail_start;
  a.half = half;
  a.tt = tt;
  uint2* words = static_cast<uint2*>(xchg);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = r == 1   ? sweep::launch<1>(up != 0, a, words, epoch, st)
                    : r == 2 ? sweep::launch<2>(up != 0, a, words, epoch, st)
                    : r == 4 ? sweep::launch<4>(up != 0, a, words, epoch, st)
                    : r == 8 ? sweep::launch<8>(up != 0, a, words, epoch, st)
                             : sweep::launch<16>(up != 0, a, words, epoch, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
