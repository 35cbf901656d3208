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
constexpr int kMaxDPerLane = 4; // psi_bwd_rows: head dim d <= 128

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

// The per-element arithmetic of the Ψ map and its VJP, shared by every
// thread mapping of psi_rows and psi_bwd_rows below.

// φ_p (and the kept ûᵀa) or φ_e of nodes r0..r0+nr-1 from projection
// `col` of row t (dot = ûᵀa_col for col < P, ûᵀω_{col−P} after).
template <bool kKeepRes>
__device__ __forceinline__ void psi_projection_out(float dot, int t, int col,
                                                   float* phi, int ldphi,
                                                   float* pa,
                                                   const PsiConsts& c, int r0,
                                                   int nr) {
  if (col < c.P) {
    if constexpr (kKeepRes) pa[t * c.P + col] = dot;
    phi[t * ldphi + col] = (dot * dot) * c.inv_sqrt_p;
  } else {
    const int j = col - c.P;
    for (int r = 0; r < nr; ++r)
      phi[t * ldphi + c.P + r * c.D + j] =
          expf(__fmul_rn(c.sqrt2s[r0 + r], dot) - c.s[r0 + r]) * c.inv_sqrt_d;
  }
}

// dproj of row t, column col: dpa = 2·pa·dφ_p/√P for col < P, dpw after
// (psi_bwd_rows's first phase), from the row's dΨ, φ and pa.
__device__ __forceinline__ float psi_dproj(const float* dp, const float* ph,
                                           const float* pa_row, int col,
                                           const PsiConsts& c, int r0,
                                           int nr) {
  const int pd = c.P * c.D;
  float acc = 0.f;
  if (col < c.P) {
    for (int r = 0; r < nr; ++r) {
      float sr = 0.f;
      for (int j = 0; j < c.D; ++j)
        sr += (dp[r * pd + col * c.D + j] * c.sqrt_w[r0 + r]) *
              ph[c.P + r * c.D + j];
      acc += sr;
    }
    return (2.f * pa_row[col]) * acc * c.inv_sqrt_p;
  }
  const int j = col - c.P;
  for (int r = 0; r < nr; ++r) {
    float de = 0.f;
    for (int p = 0; p < c.P; ++p)
      de += (dp[r * pd + p * c.D + j] * c.sqrt_w[r0 + r]) * ph[p];
    acc += (c.sqrt2s[r0 + r] * ph[c.P + r * c.D + j]) * de;
  }
  return acc;
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
//
// A node range r0, nr (default: all R nodes) restricts φ_e and Ψ to
// nodes r0..r0+nr-1: phi is then (n, P + nr·D) and psi holds the range's
// nr·P·D columns, each computed exactly as in the full map. kSlice maps
// threads for a block that holds one node's slice (K1, K3, K4): a lane
// keeps one row against a few projection columns (rows of u and aw
// 16-byte aligned, P + D <= 32), and a thread keeps four Ψ columns, where
// the shapes allow; each value is the same as in the default mapping. With
// kSlice, rows before psi_from get everything but their Ψ columns (for a
// block that never reads them).
template <bool kKeepRes = false, bool kSlice = false>
__device__ inline void psi_rows(float* u, int ldu, int n, int d, const float* aw,
                         int ldw, float* phi, float* psi, int ldp,
                         const PsiConsts& c, float* pa = nullptr,
                         float* inv_out = nullptr, int r0 = 0, int nr = -1,
                         int psi_from = 0) {
  if (nr < 0) nr = c.R;
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
  const int npd = c.P + c.D, ldphi = c.P + nr * c.D;
  const int pd = c.P * c.D, m = nr * pd;
  constexpr int RB = 4;   // projection columns a lane carries (kSlice)
  if (kSlice && npd <= RB * nwarps && d % 4 == 0 && ldu % 4 == 0 &&
      ldw % 4 == 0) {
    // Lane = row, warp = every nwarps-th column: û rows and projection
    // rows read as float4 (16-byte aligned rows), each û load shared by
    // the warp's columns, each projection load a broadcast.
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int t = t0 + lane;
      const float* ur = u + (t < n ? t : 0) * ldu;
      float dot[RB] = {};
#pragma unroll 2
      for (int i = 0; i < d; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(ur + i);
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int col = warp + k * nwarps;
          if (col < npd) {
            const float4 a = *reinterpret_cast<const float4*>(aw + col * ldw + i);
            dot[k] += x.x * a.x;
            dot[k] += x.y * a.y;
            dot[k] += x.z * a.z;
            dot[k] += x.w * a.w;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RB; ++k)
        if (t < n && warp + k * nwarps < npd)
          psi_projection_out<kKeepRes>(dot[k], t, warp + k * nwarps, phi,
                                       ldphi, pa, c, r0, nr);
    }
  } else {
    for (int idx = tid; idx < n * npd; idx += blockDim.x) {
      const int t = idx / npd, col = idx % npd;
      float dot = 0.f;
      for (int i = 0; i < d; ++i) dot += u[t * ldu + i] * aw[col * ldw + i];
      psi_projection_out<kKeepRes>(dot, t, col, phi, ldphi, pa, c, r0, nr);
    }
  }
  __syncthreads();
  // Kronecker fusion per node, scaled by √w_r.
  if (kSlice && m % 4 == 0 && (int)blockDim.x % (m / 4) == 0 &&
      c.D % 4 == 0 && ldp % 4 == 0 && ldphi % 4 == 0 && c.P % 4 == 0) {
    // A thread keeps four neighbouring Ψ columns (one p, four j): φ_e and
    // Ψ move as float4 (16-byte aligned rows).
    const int col = 4 * (tid % (m / 4)), r = col / pd, p = (col % pd) / c.D;
    const int j = col % c.D;
    const float sw = c.sqrt_w[r0 + r];
    for (int t = psi_from + tid / (m / 4); t < n; t += blockDim.x / (m / 4)) {
      const float php = phi[t * ldphi + p];
      const float4 phe = *reinterpret_cast<const float4*>(
          phi + t * ldphi + c.P + r * c.D + j);
      *reinterpret_cast<float4*>(psi + t * ldp + col) =
          make_float4((php * phe.x) * sw, (php * phe.y) * sw,
                      (php * phe.z) * sw, (php * phe.w) * sw);
    }
  } else {
    for (int idx = tid; idx < n * m; idx += blockDim.x) {
      const int t = idx / m, col = idx % m;
      if (kSlice && t < psi_from) continue;
      const int r = col / pd, p = (col % pd) / c.D, j = col % c.D;
      psi[t * ldp + col] =
          (phi[t * ldphi + p] * phi[t * ldphi + c.P + r * c.D + j]) *
          c.sqrt_w[r0 + r];
    }
  }
  __syncthreads();
}

// psi_bwd_rows's last phase with each warp carrying two rows at once: dû =
// dpa·A + dpw·Ω and du = inv·(dû − û (ûᵀdû)) per row, in place of û. The
// sums run in the same order as the one-row-per-warp loop. Ends past a
// __syncthreads().
__device__ inline void psi_bwd_du_rows(float* u, int ldu, int n, int d,
                                       const float* aw, int ldw,
                                       const float* inv, const float* dproj,
                                       int npd, const PsiConsts& c) {
  constexpr int Q = kMaxDPerLane, RW = 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t0 = warp; t0 < n; t0 += RW * nwarps) {
    int tr[RW];
#pragma unroll
    for (int k = 0; k < RW; ++k)
      tr[k] = t0 + k * nwarps < n ? t0 + k * nwarps : t0;
    // sa = Σ_p dpa·A and sw = Σ_j dpw·Ω per row and column, each anchor or
    // omega value loaded once for the warp's rows.
    float sa[RW][Q] = {}, sw[RW][Q] = {};
#pragma unroll 4
    for (int p = 0; p < c.P; ++p)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (lane + 32 * q < d) {
          const float a = aw[p * ldw + lane + 32 * q];
#pragma unroll
          for (int k = 0; k < RW; ++k) sa[k][q] += dproj[tr[k] * npd + p] * a;
        }
#pragma unroll 4
    for (int j = 0; j < c.D; ++j)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (lane + 32 * q < d) {
          const float w = aw[(c.P + j) * ldw + lane + 32 * q];
#pragma unroll
          for (int k = 0; k < RW; ++k)
            sw[k][q] += dproj[tr[k] * npd + c.P + j] * w;
        }
    float uh[RW][Q], duh[RW][Q], dot[RW];
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      dot[k] = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = lane + 32 * q;
        uh[k][q] = duh[k][q] = 0.f;
        if (i < d) {
          duh[k][q] = sa[k][q] + sw[k][q];
          uh[k][q] = u[tr[k] * ldu + i];
          dot[k] += uh[k][q] * duh[k][q];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RW; ++k) dot[k] = warp_sum(dot[k]);
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      const int t = t0 + k * nwarps;
      if (t >= n) continue;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = lane + 32 * q;
        if (i < d) u[t * ldu + i] = inv[t] * (duh[k][q] - uh[k][q] * dot[k]);
      }
    }
  }
  __syncthreads();
}

// The closed-form VJP of psi_rows for n rows, computed by the whole block
// (repro/kernels/common.py::features_bwd):
//
//   u     (n, ldu)   û in (as psi_rows left it); du out, in place
//   aw    (P + D, ldw) anchors then omegas
//   phi   (n, P + nr·D) φ_p then φ_e per node, as psi_rows left them
//   pa    (n, P), inv (n)  kept by psi_rows<true>
//   dpsi  (n, ldp)   dΨ of the nr·P·D columns of nodes r0..r0+nr-1
//   dproj (n, P + D) scratch: dpa then dpw
//   daw   (P + D, d) this block's sums of dA rows then dΩ rows; added to
//
// dφ_p = Σ_r Σ_j √w_r dΨ φ_e,  dpa = 2·pa·dφ_p/√P,
// dpw = Σ_r √(2s_r) φ_e ∘ (Σ_p √w_r dΨ φ_p),  dû = dpa·A + dpw·Ω,
// dA += dpaᵀ û,  dΩ += dpwᵀ û,  du = inv·(dû − û (ûᵀdû)).
// Starts and ends with every thread past a __syncthreads(). With a node
// range (psi_rows's, default all nodes) the sums over r run over the
// range only: the VJP of dΨ restricted to those nodes. It is linear in
// dΨ, so the VJPs of a partition of the nodes sum to the full one.
// kSlice maps threads for a one-node block (K3, K4): dpa and dpw items on
// separate threads, a thread keeps one column i of û for a few
// neighbouring dA/dΩ rows, and a warp two rows of du, where the shapes
// allow; each value is the same as in the default mapping.
template <bool kSlice = false>
__device__ inline void psi_bwd_rows(float* u, int ldu, int n, int d,
                                    const float* aw, int ldw, const float* phi,
                                    const float* pa, const float* inv,
                                    const float* dpsi, int ldp, float* dproj,
                                    float* daw, const PsiConsts& c,
                                    int r0 = 0, int nr = -1) {
  if (nr < 0) nr = c.R;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int npd = c.P + c.D, ldphi = c.P + nr * c.D;
  const int np = n * c.P;
  if (kSlice && np < (int)blockDim.x) {
    // The first np threads take the rows' dpa items (D terms each), the
    // rest their dpw items (P terms each, several per thread), so that
    // each warp takes one branch of psi_dproj.
    if (tid < np) {
      const int t = tid / c.P, col = tid % c.P;
      dproj[t * npd + col] = psi_dproj(dpsi + t * ldp, phi + t * ldphi,
                                       pa + t * c.P, col, c, r0, nr);
    } else {
      for (int i = tid - np; i < n * c.D; i += blockDim.x - np) {
        const int t = i / c.D, col = c.P + i % c.D;
        dproj[t * npd + col] = psi_dproj(dpsi + t * ldp, phi + t * ldphi,
                                         pa + t * c.P, col, c, r0, nr);
      }
    }
  } else {
    for (int idx = tid; idx < n * npd; idx += blockDim.x) {
      const int t = idx / npd, col = idx % npd;
      dproj[t * npd + col] = psi_dproj(dpsi + t * ldp, phi + t * ldphi,
                                       pa + t * c.P, col, c, r0, nr);
    }
  }
  __syncthreads();
  constexpr int CB = 8;   // dA/dΩ rows one thread carries at once (kSlice)
  const int groups = (int)blockDim.x / d;
  const int cb = (npd + groups - 1) / groups;   // rows per thread
  if (kSlice && (int)blockDim.x % d == 0 && cb <= CB && cb % 2 == 0 &&
      npd % 2 == 0) {
    // Thread (row group, column i): cb neighbouring dA/dΩ rows, their dproj
    // values read in pairs.
    const int i = tid % d, col0 = (tid / d) * cb;
    float acc[CB] = {};
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float uv = u[t * ldu + i];
#pragma unroll
      for (int k = 0; k < CB; k += 2)
        if (k < cb && col0 + k < npd) {
          const float2 dp2 =
              *reinterpret_cast<const float2*>(dproj + t * npd + col0 + k);
          acc[k] += dp2.x * uv;
          acc[k + 1] += dp2.y * uv;
        }
    }
#pragma unroll
    for (int k = 0; k < CB; ++k)
      if (k < cb && col0 + k < npd) daw[(col0 + k) * d + i] += acc[k];
  } else {
    for (int idx = tid; idx < npd * d; idx += blockDim.x) {
      const int col = idx / d, i = idx % d;
      float acc = 0.f;
      for (int t = 0; t < n; ++t) acc += dproj[t * npd + col] * u[t * ldu + i];
      daw[col * d + i] += acc;
    }
  }
  __syncthreads();
  if (kSlice) {
    psi_bwd_du_rows(u, ldu, n, d, aw, ldw, inv, dproj, npd, c);
    return;
  }
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

// -- asynchronous copies to shared memory, and residency -----------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Residency of kernel fn at `threads` threads and `smem` bytes of dynamic
// shared memory (its attribute set first): out[0] blocks per SM, out[1]
// blocks resident at once on the card, out[2] registers per thread, out[3]
// local (spill) bytes per thread, out[4] dynamic shared memory per block,
// out[5] `tile`, the kernel's own unit of work. Returns a cudaError_t code.
inline int block_residency(const void* fn, int threads, size_t smem, int tile,
                           int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  out[1] = out[0] * sms;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)smem;
  out[5] = tile;
  return 0;
}

// causal_mask: score (t, u) survives when u <= t.
__device__ __forceinline__ bool causal_keep(int t, int u) { return u <= t; }

}  // namespace slay
