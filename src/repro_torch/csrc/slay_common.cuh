// Device code shared by the SLAY CUDA kernels.
//
// Port of repro/kernels/common.py (features_fwd, features_bwd,
// causal_mask). The plain PyTorch twins are
// repro_torch/kernels/common.py::features_fwd and ::features_bwd; keep the
// arithmetic of each pair in the same order.
#pragma once

#include <cmath>
#include <cstdint>

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

// The constants above from the host's float64 quadrature (R <= kMaxNodes).
inline PsiConsts make_psi_consts(int P, int D, int R, const double* s_nodes,
                                 const double* sqrt_w) {
  PsiConsts c;
  for (int r = 0; r < kMaxNodes; ++r) {
    const double s = r < R ? s_nodes[r] : 0.0;
    c.sqrt2s[r] = (float)sqrt(2.0 * s);
    c.s[r] = (float)s;
    c.sqrt_w[r] = r < R ? (float)sqrt_w[r] : 0.f;
  }
  c.inv_sqrt_p = (float)(1.0 / sqrt((double)P));
  c.inv_sqrt_d = (float)(1.0 / sqrt((double)D));
  c.R = R;
  c.P = P;
  c.D = D;
  return c;
}

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

// Anchors (P, d) then omegas (D, d) to aw (P + D, ldw) in fp32 shared
// memory, by the whole block. No sync.
__device__ inline void load_projections(const float* anchors,
                                        const float* omegas, int d,
                                        const PsiConsts& c, float* aw,
                                        int ldw) {
  for (int i = threadIdx.x; i < (c.P + c.D) * d; i += blockDim.x) {
    const int row = i / d, col = i % d;
    aw[row * ldw + col] =
        row < c.P ? anchors[row * d + col] : omegas[(row - c.P) * d + col];
  }
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
// thread past a __syncthreads(). With kKeepRes it also keeps what the
// backward needs beyond û and phi: pa (n, P) = ûᵀa, whose sign φ_p
// loses, and inv (n) = rsqrt(‖u‖² + ε).
template <bool kKeepRes = false>
__device__ inline void psi_rows(float* u, int ldu, int n, int d, const float* aw,
                         int ldw, float* phi, float* psi, int ldp,
                         const PsiConsts& c, float* pa = nullptr,
                         float* inv_out = nullptr) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  // normalize: one warp per row, rsqrt of the fp32 square sum.
  for (int t = warp; t < n; t += nwarps) {
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += u[t * ldu + i] * u[t * ldu + i];
    const float inv = rsqrtf(warp_sum(acc) + 1e-6f);
    if constexpr (kKeepRes) {
      if (lane == 0) inv_out[t] = inv;
    }
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
      if constexpr (kKeepRes) pa[t * c.P + col] = dot;
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

constexpr int kMaxDPerLane = 4;   // psi_bwd_rows: head dim d <= 128

// The closed-form VJP of psi_rows for n rows, computed by the whole block
// (repro/kernels/common.py::features_bwd):
//
//   u     (n, ldu)   û in (as psi_rows left it); du out, in place
//   aw    (P + D, ldw) anchors then omegas
//   phi   (n, P + R·D) φ_p then φ_e per node, as psi_rows left them
//   pa    (n, P), inv (n)  kept by psi_rows<true>
//   dpsi  (n, ldp)   dΨ
//   dproj (n, P + D) scratch: dpa then dpw
//   daw   (P + D, d) this block's sums of dA rows then dΩ rows; added to
//
// dφ_p = Σ_r Σ_j √w_r dΨ φ_e,  dpa = 2·pa·dφ_p/√P,
// dpw = Σ_r √(2s_r) φ_e ∘ (Σ_p √w_r dΨ φ_p),  dû = dpa·A + dpw·Ω,
// dA += dpaᵀ û,  dΩ += dpwᵀ û,  du = inv·(dû − û (ûᵀdû)).
// Starts and ends with every thread past a __syncthreads().
__device__ inline void psi_bwd_rows(float* u, int ldu, int n, int d,
                                    const float* aw, int ldw, const float* phi,
                                    const float* pa, const float* inv,
                                    const float* dpsi, int ldp, float* dproj,
                                    float* daw, const PsiConsts& c) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int npd = c.P + c.D, ldphi = c.P + c.R * c.D, pd = c.P * c.D;
  for (int idx = tid; idx < n * npd; idx += blockDim.x) {
    const int t = idx / npd, col = idx % npd;
    const float* dp = dpsi + t * ldp;
    const float* ph = phi + t * ldphi;
    float acc = 0.f;
    if (col < c.P) {
      for (int r = 0; r < c.R; ++r) {
        float sr = 0.f;
        for (int j = 0; j < c.D; ++j)
          sr += (dp[r * pd + col * c.D + j] * c.sqrt_w[r]) * ph[c.P + r * c.D + j];
        acc += sr;
      }
      dproj[t * npd + col] = (2.f * pa[t * c.P + col]) * acc * c.inv_sqrt_p;
    } else {
      const int j = col - c.P;
      for (int r = 0; r < c.R; ++r) {
        float de = 0.f;
        for (int p = 0; p < c.P; ++p)
          de += (dp[r * pd + p * c.D + j] * c.sqrt_w[r]) * ph[p];
        acc += (c.sqrt2s[r] * ph[c.P + r * c.D + j]) * de;
      }
      dproj[t * npd + col] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < npd * d; idx += blockDim.x) {
    const int col = idx / d, i = idx % d;
    float acc = 0.f;
    for (int t = 0; t < n; ++t) acc += dproj[t * npd + col] * u[t * ldu + i];
    daw[col * d + i] += acc;
  }
  __syncthreads();
  // One warp per row: the row's û is read before its du overwrites it.
  for (int t = warp; t < n; t += nwarps) {
    float uh[kMaxDPerLane], duh[kMaxDPerLane];
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxDPerLane; ++q) {
      const int i = lane + 32 * q;
      uh[q] = duh[q] = 0.f;
      if (i < d) {
        float sa = 0.f, sw = 0.f;
        for (int p = 0; p < c.P; ++p)
          sa += dproj[t * npd + p] * aw[p * ldw + i];
        for (int j = 0; j < c.D; ++j)
          sw += dproj[t * npd + c.P + j] * aw[(c.P + j) * ldw + i];
        duh[q] = sa + sw;
        uh[q] = u[t * ldu + i];
        dot += uh[q] * duh[q];
      }
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int q = 0; q < kMaxDPerLane; ++q) {
      const int i = lane + 32 * q;
      if (i < d) u[t * ldu + i] = inv[t] * (duh[q] - uh[q] * dot);
    }
  }
  __syncthreads();
}

// A block's dA and dΩ sums (daw, as psi_bwd_rows left them) to row `row`
// of da (rows, P, d) and dw (rows, D, d). No sync.
__device__ inline void store_daw(const float* daw, float* da, float* dw,
                                 int row, int d, const PsiConsts& c) {
  for (int i = threadIdx.x; i < (c.P + c.D) * d; i += blockDim.x) {
    if (i < c.P * d)
      da[(int64_t)row * c.P * d + i] = daw[i];
    else
      dw[(int64_t)row * c.D * d + i - c.P * d] = daw[i];
  }
}

// causal_mask: score (t, u) survives when u <= t.
__device__ __forceinline__ bool causal_keep(int t, int u) { return u <= t; }

}  // namespace slay
