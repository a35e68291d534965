// 9-point complex stencil matvec y = S u on Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_stencil.py:kernel_shifted (launched by
// stencil_matvec_2d) of the JAX package: for a (m, n, 3, 3) complex stencil
// field S and a complex (m, n) field u,
//
//     y[j, i] = sum_{dj, di} S[j, i, dj, di] u[j + dj - 1, i + di - 1],
//
// taps outside the grid counting as zero, in float32 arithmetic with the taps
// summed in the order (dj, di) = (0, 0), (0, 1), ... (2, 2) as the TPU kernel
// does, each tap's complex product formed as (sr ur - si ui, sr ui + si ur).
// The field and u arrive as complex64 (the wrapper casts a complex128 field
// down and the result back up, as the JAX package computes in float32 too).
//
// Design.  The TPU kernel splits re/im into separate planes and passes three
// row-shifted copies of u, because its VMEM blocks cannot overlap; none of
// that is needed here.  One thread computes one node.  A block of kNodes
// consecutive nodes (in the flat j n + i order) first copies their 9 x 8
// bytes of stencil, one contiguous run of kNodes x 72 bytes, into shared
// memory with coalesced 16-byte loads, then each thread reads its 9 taps from
// there and its 9 neighbours of u through the read-only cache (u is 5 MB at
// 801^2 and lies in L2; neighbouring threads share most neighbours).
//
// Bound: bytes.  The field once (72 B a node), u once and y once (8 B a node
// each): 56.5 MB at 801^2, 16.9 us at 3.35 TB/s.  The 72 flop a node are far
// below the f32 rate.
//
// stencil_matvec launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include <cuda_runtime.h>

namespace stencil {

constexpr int kNodes = 128;            // nodes (threads) per block

__global__ void __launch_bounds__(kNodes)
    matvec_kernel(const float2* __restrict__ vals, const float2* __restrict__ u,
                  float2* __restrict__ y, int m, int n) {
  __shared__ __align__(16) float2 s_vals[kNodes * 9];
  const long long total = (long long)m * n;
  const long long first = (long long)blockIdx.x * kNodes;
  const int count = (int)(total - first < kNodes ? total - first : kNodes);

  // the block's stencil rows: count x 9 complex values, back to back
  const float4* src = reinterpret_cast<const float4*>(vals + first * 9);
  float4* dst = reinterpret_cast<float4*>(s_vals);
  const int words = count * 9;                   // float2 values
  for (int k = threadIdx.x; k < words / 2; k += kNodes) dst[k] = __ldg(src + k);
  if ((words & 1) && threadIdx.x == 0) s_vals[words - 1] = __ldg(vals + first * 9 + words - 1);
  __syncthreads();

  if (threadIdx.x >= count) return;
  const long long node = first + threadIdx.x;
  const int j = (int)(node / n), i = (int)(node - (long long)j * n);
  const float2* sv = s_vals + threadIdx.x * 9;
  float acc_re = 0.f, acc_im = 0.f;
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    const int jj = j + dj - 1;
    if (jj < 0 || jj >= m) continue;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int ii = i + di - 1;
      if (ii < 0 || ii >= n) continue;
      const float2 s = sv[dj * 3 + di];
      const float2 v = __ldg(u + (long long)jj * n + ii);
      acc_re = acc_re + (s.x * v.x - s.y * v.y);
      acc_im = acc_im + (s.x * v.y + s.y * v.x);
    }
  }
  y[node] = make_float2(acc_re, acc_im);
}

}  // namespace stencil

extern "C" int stencil_matvec(
    const void* vals,        // (m, n, 3, 3) complex64
    const void* u,           // (m, n) complex64
    void* y,                 // (m, n) complex64
    int m, int n, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)m * n;
  const long long blocks = (total + stencil::kNodes - 1) / stencil::kNodes;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stencil::matvec_kernel<<<(unsigned)blocks, stencil::kNodes, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(vals), static_cast<const float2*>(u), static_cast<float2*>(y),
      m, n);
  return (int)cudaGetLastError();
}
