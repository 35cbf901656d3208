// Fused causal SLAY attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/slay_fused.py::_fwd_kernel (B1).
// For each q row h (kv row h / G) it walks the sequence in tiles of
// kTile tokens and, per tile,
//
//   Ψq, Ψk  = Ψ(q_tile), Ψ(k_tile)                 (shared memory only)
//   num     = Ψq·S + tril(Ψq Ψkᵀ)·V,  den = Ψq·z + rowsum(tril(Ψq Ψkᵀ))
//   y       = num / (den + δ),  den written without δ (backward residual)
//   S      += Ψkᵀ V,  z += Σ Ψk                   (fp32, shared memory)
//
// Ψ never touches device memory; per token only raw q/k/v are read and y,
// den written. The TPU kernel's sequential chunk grid axis becomes the
// tile loop inside one block. The tile (16 tokens) is smaller than the
// API's chunk_size: at slayformer shapes the (S, z) carry alone is
// 384 x 64 fp32 = 96 KiB and Ψ of a whole 256-token chunk would be
// 384 KiB per operand, beyond the 227 KB a block may hold. Chunking is only
// an order of evaluation, so any tile gives the same result up to rounding.
//
// What bounds it: per token and q head it does ≈ 4·m·dv + (T+1)·(m+dv)
// FLOP plus the two Ψ maps, against ≈ 516 bytes of bf16 traffic, so it is
// bound by operations. This first version runs them on the fp32 pipes out
// of shared memory (each thread register-blocks kTile·DV/256 output rows
// against one S column), one block per q row: at batch 4 that is 48 blocks
// on 132 SMs. Tensor cores (wgmma), a dv split for occupancy and TMA loads
// are left for later work. The per-tile scan phases are in scan_tile.cuh,
// shared with K3, K4 and the two-dispatch scan (slay_scan.cu).
#include <cmath>
#include <cstdint>

#include "scan_tile.cuh"

namespace slay {

struct FusedDims {
  int L, d, G, m;
  float delta;
};

// Shared-memory carve-up (floats); every size is a row count times a
// padded stride, so the host computes the same total in fused_smem_bytes.
struct FusedLayout {
  int ldu, ldw, ldp, ldphi;
  int off_s, off_z, off_u, off_aw, off_phi, off_psi, off_v, off_sc, off_den;
  int total;
};

__host__ __device__ inline FusedLayout fused_layout(int d, int dv, int m,
                                                    int P, int D, int R) {
  FusedLayout l;
  l.ldu = d + 1;
  l.ldw = d + 1;
  l.ldp = m + 1;
  l.ldphi = P + R * D;
  int o = 0;
  l.off_s = o;   o += m * dv;
  l.off_z = o;   o += m;
  l.off_u = o;   o += 2 * kTile * l.ldu;
  l.off_aw = o;  o += (P + D) * l.ldw;
  l.off_phi = o; o += 2 * kTile * l.ldphi;
  l.off_psi = o; o += 2 * kTile * l.ldp;
  l.off_v = o;   o += kTile * dv;
  l.off_sc = o;  o += kTile * (kTile + 1);
  l.off_den = o; o += kTile;
  l.total = o;
  return l;
}

template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 1)
fused_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ anchors,
                 const float* __restrict__ omegas, T* __restrict__ y,
                 float* __restrict__ den_out, FusedDims dims, PsiConsts c) {
  extern __shared__ float smem[];
  const int L = dims.L, d = dims.d, m = dims.m;
  const FusedLayout lay = fused_layout(d, DV, m, c.P, c.D, c.R);
  float* S = smem + lay.off_s;
  float* z = smem + lay.off_z;
  float* u = smem + lay.off_u;          // rows 0..T-1 q, T..2T-1 k
  float* aw = smem + lay.off_aw;
  float* phi = smem + lay.off_phi;
  float* psi = smem + lay.off_psi;      // rows 0..T-1 Ψq, T..2T-1 Ψk
  float* vs = smem + lay.off_v;
  float* sc = smem + lay.off_sc;
  float* den_s = smem + lay.off_den;
  const float* psiq = psi;
  const float* psik = psi + kTile * lay.ldp;
  const int ldp = lay.ldp, ldsc = kTile + 1;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, hk = h / dims.G;

  for (int i = tid; i < m * DV; i += kThreads) S[i] = 0.f;
  for (int i = tid; i < m; i += kThreads) z[i] = 0.f;
  load_projections(anchors, omegas, d, c, aw, lay.ldw);

  for (int t0 = 0; t0 < L; t0 += kTile) {
    // Raw tiles to fp32 shared memory, zero rows past L.
    for (int i = tid; i < kTile * d; i += kThreads) {
      const int t = i / d, col = i % d;
      const bool in = t0 + t < L;
      const int64_t gq = ((int64_t)h * L + t0 + t) * d + col;
      const int64_t gk = ((int64_t)hk * L + t0 + t) * d + col;
      u[t * lay.ldu + col] = in ? to_f32(q[gq]) : 0.f;
      u[(kTile + t) * lay.ldu + col] = in ? to_f32(k[gk]) : 0.f;
    }
    for (int i = tid; i < kTile * DV; i += kThreads) {
      const int t = i / DV, col = i % DV;
      vs[i] = t0 + t < L ? to_f32(v[((int64_t)hk * L + t0 + t) * DV + col])
                         : 0.f;
    }
    __syncthreads();
    // Ψ of the 2T rows, then the scan phases (scan_tile.cuh).
    psi_rows(u, lay.ldu, 2 * kTile, d, aw, lay.ldw, phi, psi, ldp, c);
    tile_scores(psiq, psik, ldp, m, sc, ldsc);
    tile_forward<T, DV>(psiq, ldp, vs, S, DV, z, m, sc, ldsc, den_s, y, den_out,
                        h, L, t0, dims.delta);
    scan_update<DV>(S, DV, z, psik, ldp, vs, nullptr, m);
  }
}

template <typename T, int DV>
int launch_fused(const void* q, const void* k, const void* v,
                 const float* anchors, const float* omegas, void* y,
                 float* den, int bh, FusedDims dims, const PsiConsts& c,
                 size_t smem, cudaStream_t stream) {
  auto kern = fused_fwd_kernel<T, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<bh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), anchors, omegas, static_cast<T*>(y), den,
      dims, c);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dv(int dv, const void* q, const void* k, const void* v,
                const float* anchors, const float* omegas, void* y, float* den,
                int bh, FusedDims dims, const PsiConsts& c, size_t smem,
                cudaStream_t stream) {
  switch (dv) {
    case 16: return launch_fused<T, 16>(q, k, v, anchors, omegas, y, den, bh,
                                        dims, c, smem, stream);
    case 32: return launch_fused<T, 32>(q, k, v, anchors, omegas, y, den, bh,
                                        dims, c, smem, stream);
    case 64: return launch_fused<T, 64>(q, k, v, anchors, omegas, y, den, bh,
                                        dims, c, smem, stream);
    case 128: return launch_fused<T, 128>(q, k, v, anchors, omegas, y, den, bh,
                                          dims, c, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace slay

extern "C" {

// Bytes of dynamic shared memory one block needs at these shapes.
long long slay_fused_smem_bytes(int d, int dv, int P, int D, int R) {
  const int m = R * P * D;
  return (long long)slay::fused_layout(d, dv, m, P, D, R).total * 4;
}

// q (bh, L, d), k (bk, L, d), v (bk, L, dv) in fp32 (dtype 0) or bf16
// (dtype 1); anchors (P, d), omegas (D, d) fp32; s_nodes, sqrt_w: R host
// doubles. Writes y (bh, L, dv) in the input dtype and den (bh, L) fp32.
// Returns a cudaError_t code (0 = launched).
int slay_fused_fwd(const void* q, const void* k, const void* v,
                   const void* anchors, const void* omegas, void* y, void* den,
                   int bh, int bk, int L, int d, int dv, int P, int D, int R,
                   const double* s_nodes, const double* sqrt_w, float delta,
                   int dtype, void* stream) {
  if (bk <= 0 || bh % bk || R < 1 || R > slay::kMaxNodes || L < 0)
    return (int)cudaErrorInvalidValue;
  const slay::PsiConsts c = slay::make_psi_consts(P, D, R, s_nodes, sqrt_w);
  slay::FusedDims dims{L, d, bh / bk, R * P * D, delta};
  const size_t smem = (size_t)slay_fused_smem_bytes(d, dv, P, D, R);
  auto st = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(anchors);
  auto w = static_cast<const float*>(omegas);
  auto dn = static_cast<float*>(den);
  if (bh == 0 || L == 0) return 0;
  if (dtype == 0)
    return slay::dispatch_dv<float>(dv, q, k, v, a, w, y, dn, bh, dims, c,
                                    smem, st);
  if (dtype == 1)
    return slay::dispatch_dv<__nv_bfloat16>(dv, q, k, v, a, w, y, dn, bh, dims,
                                            c, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
