// Backward plane substitution of the 3D block-Thomas solve on Hopper (sm_90a).
//
// Replaces the TPU kernel sparse/pallas_plane.py:_bwd_slab_kernel (launched
// by _bwd_slab_call) of the JAX package: for the planes p = l-1 down to
// start of one slab,
//
//     x_p = (y_p - S'_p(x_{p+1})) . P[base + p],     x_l = 0,
//
// with S'_p the 9-tap in-plane coupling stencil to plane p+1 and P the
// transposed pivot plane: bf16, or int8 with one f32 scale per (128-input-row
// block, output lane).  start = l - tail computes only the last
// `tail` planes, which is exact: the recursion starts at the true last plane.
// Planes < start of the x stack belong to the caller.
//
// The kernels are plane::flow_kernel<R, true, S>, the backward
// instantiations of the body in plane_pass.cuh for S = Storage::kBf16 and
// Storage::kInt8, which describes the design, the limits and the bound.  The
// carry x_{p+1} and y_p - S'_p(x_{p+1}) travel as flagged exchange words (the
// latter double-buffered: a fast CTA forms the next plane's lanes while a
// slow one still reads this plane's); at r = 4 and 8 the latter as plain rows
// in the caller's two-plane scratch, each CTA flagging its lanes (note 4);
// the x stack is only written.
//
// Bound: bytes.  (l - start) planes x 2 x ld^2 x 2 B in bf16 (0.304 ms for
// 48 planes at mn = 2304), 2 x ld^2 x 1 B plus the scales in int8 (0.56 ms
// for 96 planes at ld = 3072), against 3.35 TB/s, plus the weight rows and
// the y and x stacks (about 1 %).
//
// plane_backward launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include "plane_pass.cuh"

extern "C" int plane_backward(
    const float* y,          // (l, 2r, ld) rows of the forward pass
    const float* w,          // (l, 2, 9, ld) weight rows of the couplings to plane p+1
    const void* pre,         // (SL, ld/8, ld, 8) bf16 or int8, tile-major, transposed
    const void* pim,
    const float* scale,      // int8: (SL, ld/8, ld/128, 2, 8) f32 scales; bf16: null
    float* x,                // (l, 2r, ld); planes < start are not touched
    float* scratch,          // r = 4, 8: (2, 2r, ld) floats for the planes' rows
                             //   y_p - S'_p(x_{p+1}); else null
    int l, int mn, int n, int ld, int r, int base, int start,
    void* xchg,              // exchange words, zeroed once: 2 slots each of y and
                             //   t words, (ld, 2r) words of (value, flag)
    unsigned epoch,          // flag of plane l - 1: planes take epoch .. epoch + l - start - 1
    void* stream) {
  plane::PassArgs a{};
  a.rhs = y;
  a.w = w;
  a.pre = pre;
  a.pim = pim;
  a.scale = scale;
  a.out = x;
  a.kept = scratch;
  a.l = l;
  a.mn = mn;
  a.n = n;
  a.ld = ld;
  a.base = base;
  a.start = start;
  cudaError_t err =
      plane::run_flow<true>(r, a, static_cast<uint2*>(xchg), epoch, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
