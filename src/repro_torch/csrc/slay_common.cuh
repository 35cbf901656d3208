// Device code shared by the SLAY CUDA kernels.
//
// Port of repro/kernels/common.py (features_fwd, causal_mask). The plain
// PyTorch twin is repro_torch/kernels/common.py::features_fwd; keep the
// arithmetic of the two in the same order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace slay {

constexpr int kThreads = 256;   // threads per block for every SLAY kernel
constexpr int kMaxNodes = 8;    // quadrature nodes R the kernels accept

// Host-computed constants of the Ψ map, passed to a kernel by value.
struct PsiConsts {
  float sqrt2s[kMaxNodes];   // √(2 s_r)
  float s[kMaxNodes];        // s_r
  float sqrt_w[kMaxNodes];   // √w_r
  float inv_sqrt_p;          // 1/√P
  float inv_sqrt_d;          // 1/√D
  int R, P, D;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as jnp.astype
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Ψ of n token rows, computed cooperatively by the whole block.
//
//   u    (n, ldu)  raw rows in fp32 shared memory; overwritten with û
//   aw   (P + D, ldw) anchors then omegas, fp32 shared memory
//   phi  (n, P + R·D) scratch: φ_p then φ_e for every node
//   psi  (n, ldp)  out: Ψ in the first m = R·P·D columns
//
// normalize → φ_p = (ûᵀa)²/√P → φ_e = exp(√(2s_r) ωᵀû − s_r)/√D →
// Ψ = (φ_p ⊗ φ_e)·√w_r, concatenated over r. Starts and ends with every
// thread past a __syncthreads().
__device__ inline void psi_rows(float* u, int ldu, int n, int d, const float* aw,
                         int ldw, float* phi, float* psi, int ldp,
                         const PsiConsts& c) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  // normalize: one warp per row, rsqrt of the fp32 square sum.
  for (int t = warp; t < n; t += nwarps) {
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += u[t * ldu + i] * u[t * ldu + i];
    const float inv = rsqrtf(warp_sum(acc) + 1e-6f);
    for (int i = lane; i < d; i += 32) u[t * ldu + i] *= inv;
  }
  __syncthreads();
  // projections on anchors and omegas, then φ_p and φ_e of every node.
  const int npd = c.P + c.D, ldphi = c.P + c.R * c.D;
  for (int idx = tid; idx < n * npd; idx += blockDim.x) {
    const int t = idx / npd, col = idx % npd;
    float dot = 0.f;
    for (int i = 0; i < d; ++i) dot += u[t * ldu + i] * aw[col * ldw + i];
    if (col < c.P) {
      phi[t * ldphi + col] = (dot * dot) * c.inv_sqrt_p;
    } else {
      const int j = col - c.P;
      for (int r = 0; r < c.R; ++r)
        phi[t * ldphi + c.P + r * c.D + j] =
            expf(__fmul_rn(c.sqrt2s[r], dot) - c.s[r]) * c.inv_sqrt_d;
    }
  }
  __syncthreads();
  // Kronecker fusion per node, scaled by √w_r.
  const int pd = c.P * c.D, m = c.R * pd;
  for (int idx = tid; idx < n * m; idx += blockDim.x) {
    const int t = idx / m, col = idx % m;
    const int r = col / pd, p = (col % pd) / c.D, j = col % c.D;
    psi[t * ldp + col] =
        (phi[t * ldphi + p] * phi[t * ldphi + c.P + r * c.D + j]) * c.sqrt_w[r];
  }
  __syncthreads();
}

// causal_mask: score (t, u) survives when u <= t.
__device__ __forceinline__ bool causal_keep(int t, int u) { return u <= t; }

}  // namespace slay
