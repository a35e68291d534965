// Cached forward block-Thomas substitution on Hopper (sm_90a), on dense or
// banded+tail pivots.
//
// Replaces three TPU kernels of the JAX package, sparse/pallas_thomas.py:
// _fwd_kernel (launched by _fwd: one slab, one right-hand side),
// _fwd_kernel_bt (launched by _fwd_bt: batch rows of r right-hand sides) and
// _fwd_kernel_ht (launched by _fwd_ht: the same on banded+tail pivots).  On
// the TPU the first two are two bodies because their block layouts differ; in
// the row layout here, (B, m, 2r, ld), the first is the second at B = 1,
// r = 1.  For each batch row and each line j = start..m-1,
//
//     y_j = b_j - L_j . t_{j-1},     t_j = C_j^{-1} y_j,     t_{start-1} = t_init,
//
// keeping BOTH stacks: y for the backward pass, t so that a later pass whose
// right-hand side differs only from some line on can resume there from
// t_init = t_{start-1} (the up pass of a Gauss-Seidel sweep resumes the down
// pass at the bottom trace lines).  Lines < start of y and t belong to the
// caller: the kernel neither reads nor writes them.
//
// Pivot layouts.  Dense (tail_start = 0): every line has a dense tile-major
// plane pair (tre, tim); hre and him are unused.  Banded+tail (tail_start >
// 0): lines j < tail_start apply their banded head window (hre, him: only
// |in - out| <= half is kept), lines j >= tail_start their dense plane
// (tre, tim, index j - tail_start); the pass crosses from one layout to the
// other in mid-pass and its carry goes on as it is.  Dense int8 planes (scale
// given: the TPU kernels' nb > 1 branch of _scaled_dots).
//
// Design.  The kernel is thomas::cached_kernel<R, kBanded, S, SPLIT>, a step
// map (CachedItems) over the flag-handoff step of thomas_flow.cuh (run_flow),
// which describes the design: one cooperative launch per pass, one CTA a tile
// (two on lines too long for one), each line's carry handed to the next
// through flagged words of the exchange buffer `xchg`, one slot per line;
// plane runs, band and right-hand rows bulk-copied ahead.  Line `start` takes
// its carry from t_init, which an earlier launch wrote, with plain loads and
// no flag; each line writes y (w) and t of its tile's lanes into the stacks.
// A head tile stages only the rows of its window that lie in [0, n), one bulk
// copy per plane, and waits only on the tiles that publish their carry lanes.
// At r = 4, 8 and 16 the map runs the wide step of thomas_flow.cuh (run_wide,
// note "Wide batches"), the one the dense passes run: line `start`'s w from
// t_init, each later line's from the rows its producers handed over; on head
// windows a tile multiplies only its window's k-steps (note "Wide batches on
// banded+tail pivots"); at r = 16 as note "Sixteen right-hand sides" says.
// Limits: r = 1, 2, 4, 8 or 16 on either layout, and the lines of
// thomas_flow.cuh (its note "Limits"; test_longest_line_fits).
//
// Bound: bytes.  Per line two dense planes, 2 x ld^2 x 2 B (int8: 1 B and the
// scales), or two head windows, 2 x ld x (8 + 2 half) x 2 B less the rows
// outside [0, n), against 3.35 TB/s, plus the b, y and t stacks.
//
// thomas_forward_cached launches only; it allocates nothing, does not
// synchronise, and returns the launch's error code (0 on success).
#include "thomas_flow.cuh"

namespace thomas {

// The cached forward pass as a step map: step k is line first + k of every
// batch row; its carry is step k - 1's, or t_init at k = 0
template <int R, bool kBanded, Storage S>
struct CachedItems {
  static constexpr bool kWindows = kBanded;      // head windows (run_wide)
  PassArgs a;
  FlowLaunch fl;

  __device__ __forceinline__ FlowTile tile(int k, int b, int t) const {
    const int j = a.first + k;
    const int s = __ldg(a.s_idx + b);
    const size_t row = (size_t)2 * R * a.ld;            // floats per (batch row, line)
    FlowTile ft = flow_tile();
    if constexpr (S == Storage::kInt8)
      ft.cols = tile_cols_int8(a.cre, a.cim, a.scale, s, j, t, a.m, a.n, a.ld);
    else
      ft.cols = tile_cols(a.cre, a.cim, a.hre, a.him, s, j, t, a.m, a.n, a.ld,
                          kBanded ? a.tail_start : 0, kBanded ? a.half : 0);
    ft.band = a.band + ((size_t)s * a.m + j) * 6 * a.ld;
    if (k > 0)
      ft.carry_step = k - 1;
    else
      ft.carry_row = a.t_init + (size_t)b * row;
    const size_t at = ((size_t)b * a.m + j) * row;
    ft.rhs = a.rhs + at;
    ft.kept = a.kept + at;
    ft.out = a.out + at;
    return ft;
  }
};

template <int R, bool kBanded, Storage S, int SPLIT>
__global__ void __launch_bounds__(flow_threads<SPLIT>(), 512 / flow_threads<SPLIT>())
    cached_kernel(const CachedItems<R, kBanded, S> items) {
  run_flow<R, S, SPLIT, false>(items, items.fl);
}

template <int R, bool kBanded, Storage S>
inline cudaError_t launch_cached(const PassArgs& a, uint2* xchg, unsigned epoch,
                                 cudaStream_t stream) {
  const CachedItems<R, kBanded, S> map{
      a, FlowLaunch{a.count, a.batch, a.n, a.ld, xchg, epoch, nullptr, 0, 0, a.rows}};
  return launch_map<R, S, false, CachedItems<R, kBanded, S>>(
      cached_kernel<R, kBanded, S, 1>, cached_kernel<R, kBanded, S, 2>, map,
      a.batch * (a.ld / kLanes), stream);
}

// r = 1, 2, 4, 8 or 16 on either layout
template <bool kBanded, Storage S>
inline cudaError_t run_cached(int r, const PassArgs& a, uint2* xchg, unsigned epoch,
                              cudaStream_t stream) {
  switch (r) {
    case 1: return launch_cached<1, kBanded, S>(a, xchg, epoch, stream);
    case 2: return launch_cached<2, kBanded, S>(a, xchg, epoch, stream);
    case 4: return launch_cached<4, kBanded, S>(a, xchg, epoch, stream);
    case 8: return launch_cached<8, kBanded, S>(a, xchg, epoch, stream);
    case 16: return launch_cached<16, kBanded, S>(a, xchg, epoch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace thomas

extern "C" int thomas_forward_cached(
    const float* b,          // (B, m, 2r, ld) right-hand rows
    const float* lband,      // (S, m, 2, 3, ld)
    const uint16_t* hre,     // (S, tail_start, ld/8, 8 + 2 half, 8) bf16 head windows
    const uint16_t* him,     //   (banded+tail only)
    const void* tre,         // (S, m - tail_start, ld/8, ld, 8) bf16 planes, tile-major,
    const void* tim,         //   or dense int8 planes (S, m, ld/8, ld, 8)
    const float* scale,      // int8: (S, m, ld/8, nb, 2, 8) scales; else null
    const int* s_idx,        // (B,)
    const float* t_init,     // (B, 2r, ld) carry into line `start`
    float* y,                // (B, m, 2r, ld); lines < start are not touched
    float* t,                // (B, m, 2r, ld); lines < start are not touched
    int batch, int m, int n, int ld, int r, int start, int tail_start, int half,
    void* xchg,              // (m - start, B, ld, 2r, 2) exchange words of 8 bytes, zeroed once
    float* rows,             // r = 4, 8, 16: (m - start) x B slots of the wide step's rows
    unsigned epoch,          // flag of line `start`: lines take epoch .. epoch + m - start - 1
    void* stream) {
  if (t_init == nullptr || (r > 2 && rows == nullptr)) return (int)cudaErrorInvalidValue;
  thomas::PassArgs a{};
  a.rhs = b;
  a.band = lband;
  a.cre = tre;
  a.cim = tim;
  a.scale = scale;
  a.hre = hre;
  a.him = him;
  a.s_idx = s_idx;
  a.t_init = t_init;
  a.kept = y;
  a.out = t;
  a.batch = batch;
  a.m = m;
  a.n = n;
  a.ld = ld;
  a.first = start;
  a.count = m - start;
  a.tail_start = tail_start;
  a.half = half;
  a.rows = rows;
  cudaError_t err = cudaErrorInvalidValue;
  const bool banded = tail_start > 0;
  if (batch >= 1 && m >= 1 && n >= 1 && ld >= n && ld % thomas::kLanes == 0 &&
      thomas::launch_width(r) && start >= 0 && start < m && xchg != nullptr && epoch != 0u &&
      epoch + (unsigned)(m - start) > epoch &&
      (!banded || (tail_start < m && half >= 0 && scale == nullptr))) {
    uint2* words = static_cast<uint2*>(xchg);
    cudaStream_t st = (cudaStream_t)stream;
    err = banded ? thomas::run_cached<true, thomas::Storage::kBf16>(r, a, words, epoch, st)
          : scale != nullptr
              ? thomas::run_cached<false, thomas::Storage::kInt8>(r, a, words, epoch, st)
              : thomas::run_cached<false, thomas::Storage::kBf16>(r, a, words, epoch, st);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
