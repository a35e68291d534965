// Backward block-Thomas substitution on Hopper (sm_90a), on dense or
// banded+tail pivots.
//
// Replaces the TPU kernels sparse/pallas_thomas.py:_bwd_kernel_b (launched by
// _bwd_b; _bwd_kernel of _bwd is the same at one batch row and one right-hand
// side) and _bwd_kernel_ht (launched by _bwd_ht, banded+tail pivots) of the
// JAX package: for each batch row, bottom-up over the lines
// j = m-1 .. m-m_eff,
//
//     x_j = C_j^{-1} (y_j - U_j . x_{j+1}),     x_m = 0,
//
// where m_eff = m for a full pass or `tail` when only the last lines are
// wanted.  Dense pivots (tail_start = 0) have a plane pair (tre, tim) on every
// line; banded+tail pivots (tail_start > 0) apply the dense plane of line j
// (j >= tail_start, index j - tail_start) or its banded head window (hre, him;
// j < tail_start).  Both run the flag-handoff line step of thomas_flow.cuh,
// which describes the design (one cooperative launch per pass, one CTA a tile,
// two on long lines, the carry handed from line to line through flagged words
// of the exchange buffer `xchg`, bulk-copied stage buffers) and the limits
// (r = 1, 2, 4, 8 or 16 on either layout):
//   - dense planes run thomas::flow_kernel<R, true, S> (bf16, or int8 when
//     scale is given) on a ring of four exchange slots; x of a line is written
//     from the carry the next line reads;
//   - banded+tail pivots run thomas::pass_map_kernel<R, true, kBf16, true>, the
//     backward pass as a step map through run_flow, the body of the cached
//     forward pass on the same layout: a head tile stages only the rows of its
//     window that lie in [0, n) and waits only on the tiles that publish its
//     carry lanes; one exchange slot per line step at r = 1, 2, the ring of
//     four at r = 4, 8, 16 (the wide step, whose tiles multiply only their
//     windows' k-steps); x is stored by the publisher of each tile.
// One with -DTHOMAS_MAP_STEP=1 (benchmarks_torch/thomas_probe.py only) runs
// dense planes through run_flow too, which measured slower than flow_kernel
// (PERF.md §6).
//
// Bound: bytes.  Per line two dense planes, 2 x ld^2 x 2 B, or two head
// windows, 2 x ld x (8 + 2 half) x 2 B less the rows outside [0, n), against
// 3.35 TB/s, plus the y and x stacks.
//
// thomas_backward launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include "thomas_flow.cuh"

extern "C" int thomas_backward(
    const float* y,          // (B, m, 2r, ld) forward-pass stack
    const float* uband,      // (S, m, 2, 3, ld)
    const uint16_t* hre,     // (S, tail_start, ld/8, 8 + 2 half, 8) bf16 head windows
    const uint16_t* him,     //   (banded+tail only)
    const void* tre,         // (S, m - tail_start, ld/8, ld, 8) bf16 planes, tile-major,
    const void* tim,         //   or dense int8 planes (S, m, ld/8, ld, 8)
    const float* scale,      // int8: (S, m, ld/8, nb, 2, 8) scales; else null
    const int* s_idx,        // (B,)
    float* x,                // (B, m_eff, 2r, ld): lines m-m_eff .. m-1
    int batch, int m, int n, int ld, int r, int m_eff, int tail_start, int half,
    void* xchg,              // exchange words of 8 bytes, zeroed once: dense planes
                             //   and r >= 4 (4, B, ld, 2r, 2), banded+tail at r = 1, 2
                             //   (m_eff, B, ld, 2r, 2)
    float* rows,             // r = 4, 8, 16: 4 x B slots of the wide step's rows; else null
    unsigned epoch,          // flag of line m-1 (lines take epoch .. + m_eff - 1)
    void* stream) {
  if (m_eff < 1 || m_eff > m) return (int)cudaErrorInvalidValue;
  thomas::PassArgs a{};
  a.rhs = y;
  a.band = uband;
  a.cre = tre;
  a.cim = tim;
  a.scale = scale;
  a.hre = hre;
  a.him = him;
  a.s_idx = s_idx;
  a.out = x;
  a.batch = batch;
  a.m = m;
  a.n = n;
  a.ld = ld;
  a.first = m - 1;
  a.count = m_eff;
  a.tail_start = tail_start;
  a.half = half;
  a.rows = rows;
  uint2* words = static_cast<uint2*>(xchg);
  cudaStream_t st = (cudaStream_t)stream;
#if THOMAS_MAP_STEP
  cudaError_t err = tail_start > 0 ? thomas::run_map_pass<true, true>(r, a, words, epoch, st)
                                   : thomas::run_map_pass<true>(r, a, words, epoch, st);
#else
  cudaError_t err = tail_start > 0 ? thomas::run_map_pass<true, true>(r, a, words, epoch, st)
                                   : thomas::run_flow_pass<true>(r, a, words, epoch, st);
#endif
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
