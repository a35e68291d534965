// Forward block-Thomas substitution on Hopper (sm_90a).
//
// Replaces the TPU kernel sparse/pallas_thomas.py:_fwd_kernel_b (launched by
// _fwd_b) of the JAX package: for each batch row and each line
// j = start..m-1,
//
//     y_j = b_j - L_j . t_{j-1},     t_j = C_j^{-1} y_j,     t_{start-1} = 0,
//
// keeping the y stack.  The kernel is thomas::flow_kernel<R, false, S>, the
// forward instantiation of the flag-handoff line step in thomas_flow.cuh,
// which also describes the design (one cooperative launch per pass, one CTA
// a tile, two on long lines, the carry handed from line to line through
// flagged words of the exchange buffer `xchg`, bulk-copied stage buffers), the limits (r = 1, 2, 4, 8 or 16) and the bound.
// With scales the planes are int8 (the TPU kernel's nb > 1 branch of
// _scaled_dots) and the kernel is flow_kernel<R, false, Storage::kInt8>.
// The carry t is never stored but in the exchange buffer.  A build with
// -DTHOMAS_MAP_STEP=1 (benchmarks_torch/thomas_probe.py only) drives the same
// pass through the step-map body of thomas_flow.cuh (run_flow, one exchange
// slot per line), which measured slower than flow_kernel (PERF.md §6).
//
// Bound: bytes.  (m - start) lines x 2 planes x n x ld x 2 B (int8: 1 B, plus
// the scales) against 3.35 TB/s, plus the b and y stacks.
//
// thomas_forward launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include "thomas_flow.cuh"

extern "C" int thomas_forward(
    const float* b,          // (B, m, 2r, ld) right-hand rows
    const float* lband,      // (S, m, 2, 3, ld)
    const void* cre,         // (S, m, ld/8, ld, 8) bf16 or int8, tile-major
    const void* cim,
    const float* scale,      // int8: (S, m, ld/8, nb, 2, 8) scales; bf16: null
    const int* s_idx,        // (B,)
    float* y,                // (B, m, 2r, ld); lines < start are not written
    void* xchg,              // (4, B, ld, 2r, 2) exchange words of 8 bytes, zeroed once
    float* rows,             // r = 4, 8, 16: 4 x B slots of the wide step's rows; else null
    int batch, int m, int n, int ld, int r, int start,
    unsigned epoch,          // flag of line `start`: lines take epoch .. epoch + m - start - 1
    void* stream) {
  thomas::PassArgs a{};
  a.rhs = b;
  a.band = lband;
  a.cre = cre;
  a.cim = cim;
  a.scale = scale;
  a.s_idx = s_idx;
  a.t_init = nullptr;
  a.kept = y;
  a.batch = batch;
  a.m = m;
  a.n = n;
  a.ld = ld;
  a.first = start;
  a.count = m - start;
  a.rows = rows;
#if THOMAS_MAP_STEP
  cudaError_t err = thomas::run_map_pass<false>(r, a, static_cast<uint2*>(xchg), epoch,
                                                (cudaStream_t)stream);
#else
  cudaError_t err = thomas::run_flow_pass<false>(r, a, static_cast<uint2*>(xchg), epoch,
                                                 (cudaStream_t)stream);
#endif
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

#if THOMAS_TRACE
// the trace of the last launch (a -DTHOMAS_TRACE=1 build only): kTraceCtas x
// kTraceItems x kTracePoints global-timer stamps
extern "C" int thomas_trace_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, thomas::g_trace, sizeof(thomas::g_trace));
}
#endif
