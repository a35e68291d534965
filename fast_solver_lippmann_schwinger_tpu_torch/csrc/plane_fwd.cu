// Forward plane substitution of the 3D block-Thomas solve on Hopper (sm_90a).
//
// Replaces the TPU kernel sparse/pallas_plane.py:_fwd_slab_kernel (launched
// by _fwd_slab_call) of the JAX package: for the planes p = start..l-1 of one
// slab,
//
//     y_p = b_p - S_p(t_{p-1}),     t_p = y_p . P[base + p],     t_{start-1} = t_init,
//
// with S_p the 9-tap in-plane coupling stencil to plane p-1 (flat shifts
// against packed weight rows) and P the transposed pivot plane: bf16, or int8
// with one f32 scale per (128-input-row block, output lane).  It
// keeps the y stack for the backward pass and, when the caller passes one,
// the t stack, so that a later pass can resume from t_{start-1}.
// Planes < start of y and t belong to the caller: the kernel neither reads
// nor writes them.
//
// The kernels are plane::flow_kernel<R, false, S>, the forward
// instantiations of the body in plane_pass.cuh for S = Storage::kBf16 and
// Storage::kInt8 (the int8 mode of the TPU kernel's _dot_plane,
// pallas_plane.py:314-326), which describes the design (one cooperative
// launch of one CTA an SM, a deep ring of bulk-copied pivot chunks, the t
// tiles and y lanes handed over as flagged exchange words: one grid-wide wait
// a plane; r = 4 and 8 on tensor cores), the limits (r = 1, 2, 4 or 8; ld <= 12448 at
// r = 2 and 3104 at r = 8 in bf16) and the bound.
// The carry travels in the exchange words; the t stack is only written.
//
// Bound: bytes.  (l - start) planes x 2 x ld^2 x 2 B in bf16 (0.304 ms for
// 48 planes at mn = 2304), 2 x ld^2 x 1 B plus the scales in int8 (0.56 ms
// for 96 planes at ld = 3072), against 3.35 TB/s, plus the weight rows and
// the b, y and t stacks (about 1 %).
//
// plane_forward launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include "plane_pass.cuh"

extern "C" int plane_forward(
    const float* b,          // (l, 2r, ld) right-hand rows
    const float* w,          // (l, 2, 9, ld) weight rows of the couplings to plane p-1
    const void* pre,         // (SL, ld/8, ld, 8) bf16 or int8, tile-major, transposed
    const void* pim,
    const float* scale,      // int8: (SL, ld/8, ld/128, 2, 8) f32 scales; bf16: null
    const float* t_init,     // (2r, ld) carry into plane `start`, or null (zero)
    float* y,                // (l, 2r, ld); planes < start are not touched
    float* t,                // (l, 2r, ld), or null; planes < start are not touched
    int l, int mn, int n, int ld, int r, int base, int start,
    void* xchg,              // exchange words, zeroed once: 2 slots each of y and
                             //   t words, (ld, 2r) words of (value, flag)
    unsigned epoch,          // flag of plane `start`: planes take epoch .. epoch + l - start - 1
    void* stream) {
  plane::PassArgs a{};
  a.rhs = b;
  a.w = w;
  a.pre = pre;
  a.pim = pim;
  a.scale = scale;
  a.t_init = t_init;
  a.kept = y;
  a.out = t;
  a.l = l;
  a.mn = mn;
  a.n = n;
  a.ld = ld;
  a.base = base;
  a.start = start;
  cudaError_t err =
      plane::run_flow<false>(r, a, static_cast<uint2*>(xchg), epoch, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
