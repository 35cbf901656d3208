// Fused causal SLAY attention backward for Hopper (sm_90a): K3 and K4.
//
// Replace the TPU kernels repro/kernels/slay_fused.py::_bwd_q_kernel (B2)
// and ::_bwd_kv_kernel (B3). Both recompute everything from raw q/k/v, as
// the forward (K1, slay_fused.cu) does, with one block per q row h (kv row
// h / G) and the TPU's sequential chunk axis as a loop over 16-token tiles
// inside the block. With G = dy/(den+δ) and h = −Σ(dy∘y)/(den+δ) per
// token and dP = tril(G Vᵀ + h 1ᵀ) per tile:
//
// K3 (B2) walks the tiles forward and carries (S, z) as K1 does:
//   dΨq = G Sᵀ + h zᵀ + dP Ψk  (S, z of the tiles before this one)
//   dq, dA, dΩ = Ψ-VJP(dΨq);   then S += Ψkᵀ V, z += Σ Ψk
// K4 (B3) walks the tiles in reverse and carries (dS, dz):
//   dV  = tril(Ψq Ψkᵀ)ᵀ G + Ψk dS
//   dΨk = dPᵀ Ψq + V dSᵀ + 1 dzᵀ  (dS, dz of the tiles after this one)
//   dk, dA, dΩ = Ψ-VJP(dΨk);   then dS += Ψqᵀ G, dz += Ψqᵀ h
//
// Outputs are per q head: dq (BH, L, d), and from K4 dk (BH, L, d) and dv
// (BH, L, dv) in the input dtype; each block also writes its own row of
// dA (BH, P, d) and dΩ (BH, D, d) in fp32. The wrapper sums dk and dv over
// each GQA group and dA, dΩ over heads and both kernels (no atomics, so
// the result does not depend on block order).
//
// What bounds them: like K1, operations. Per token and q head each kernel
// does the Ψ maps of its q and k rows, ≈ 2·m·dv for the state term
// (G Sᵀ, or Ψk dS and V dSᵀ) and the causal work inside a tile, against
// ≈ 6 values of traffic per token and feature column. This first version
// runs them on the fp32 pipes out of shared memory, one block of 256
// threads per q row; wgmma, TMA and a dv split are later work.
//
// Shared memory at slayformer shapes (d = dv = 64, m = 384) is 191.6 KB
// of the 227 KB a block may have: the fp32 carry (m x (dv+1), padded so
// that threads owning neighbouring features read different banks), Ψ of
// the tile's 2T rows, their residuals, G, dP and the dA/dΩ sums. dΨ
// overwrites Ψq (K3, which never reads Ψq) or Ψk (K4, after dV has read
// it), and du overwrites û in place. The per-tile scan phases are in
// scan_tile.cuh, shared with K1 and with the two-dispatch scan
// (slay_scan.cu).
#include <cstdint>

#include "scan_tile.cuh"

namespace slay {

struct BwdDims {
  int L, d, G, m;
  float delta;
};

// Shared-memory carve-up (floats), as fused_layout in slay_fused.cu.
struct BwdLayout {
  int ldu, ldw, ldp, ldphi, lds, ldsc;
  int off_s, off_z, off_u, off_aw, off_phi, off_psi, off_v, off_g, off_h,
      off_sc, off_dp, off_pa, off_inv, off_dproj, off_daw;
  int total;
};

__host__ __device__ inline BwdLayout bwd_layout(int d, int dv, int m, int P,
                                                int D, int R) {
  constexpr int T = kTile;
  BwdLayout l;
  l.ldu = d + 1;
  l.ldw = d + 1;
  l.ldp = m + 1;
  l.ldphi = P + R * D;
  l.lds = dv + 1;
  l.ldsc = T + 1;
  int o = 0;
  l.off_s = o;     o += m * l.lds;
  l.off_z = o;     o += m;
  l.off_u = o;     o += 2 * T * l.ldu;
  l.off_aw = o;    o += (P + D) * l.ldw;
  l.off_phi = o;   o += 2 * T * l.ldphi;
  l.off_psi = o;   o += 2 * T * l.ldp;
  l.off_v = o;     o += T * dv;
  l.off_g = o;     o += T * dv;
  l.off_h = o;     o += T;
  l.off_sc = o;    o += T * l.ldsc;
  l.off_dp = o;    o += T * l.ldsc;
  l.off_pa = o;    o += 2 * T * P;
  l.off_inv = o;   o += 2 * T;
  l.off_dproj = o; o += T * (P + D);
  l.off_daw = o;   o += (P + D) * d;
  l.total = o;
  return l;
}

// Block-wide set-up: zero the carry and the dA/dΩ sums, stage anchors and
// omegas in shared memory.
__device__ inline void bwd_init(float* carry, int n_carry, float* daw,
                                int n_daw, float* aw, int ldw,
                                const float* anchors, const float* omegas,
                                int d, const PsiConsts& c) {
  for (int i = threadIdx.x; i < n_carry; i += blockDim.x) carry[i] = 0.f;
  for (int i = threadIdx.x; i < n_daw; i += blockDim.x) daw[i] = 0.f;
  load_projections(anchors, omegas, d, c, aw, ldw);
}

// One tile's inputs: raw q rows (0..T-1) and k rows (T..2T-1) of u, v,
// and the cotangents G = dy/e, h = −Σ(dy∘y)/e with e = den + δ. Rows past
// L are zero (their Ψ is zero and they add nothing).
template <typename T, int DV>
__device__ inline void bwd_load_tile(const T* q, const T* k, const T* v,
                                     const T* dy, const T* y, const float* den,
                                     int h, int hk, int t0, const BwdDims& dims,
                                     const BwdLayout& lay, float* u, float* vs,
                                     float* gs, float* hs) {
  constexpr int TT = kTile;
  const int tid = threadIdx.x, L = dims.L, d = dims.d;
  for (int i = tid; i < TT * d; i += blockDim.x) {
    const int t = i / d, col = i % d;
    const bool in = t0 + t < L;
    const int64_t gq = ((int64_t)h * L + t0 + t) * d + col;
    const int64_t gk = ((int64_t)hk * L + t0 + t) * d + col;
    u[t * lay.ldu + col] = in ? to_f32(q[gq]) : 0.f;
    u[(TT + t) * lay.ldu + col] = in ? to_f32(k[gk]) : 0.f;
  }
  for (int i = tid; i < TT * DV; i += blockDim.x) {
    const int t = i / DV, col = i % DV;
    vs[i] = t0 + t < L ? to_f32(v[((int64_t)hk * L + t0 + t) * DV + col]) : 0.f;
  }
  load_cotangents<T, DV>(dy, y, den, h, t0, L, dims.delta, gs, hs);
}

// Rows t0..t0+T-1 of a (rows, L, d) output from fp32 shared rows.
template <typename T>
__device__ inline void bwd_store_rows(T* out, int row, int t0, int L, int d,
                                      const float* u, int ldu) {
  for (int i = threadIdx.x; i < kTile * d; i += blockDim.x) {
    const int t = i / d, col = i % d;
    if (t0 + t < L)
      out[((int64_t)row * L + t0 + t) * d + col] = from_f32<T>(u[t * ldu + col]);
  }
}

// K3: forward re-scan -> dq and the q-path dA/dΩ partials.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 1)
fused_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ anchors,
                   const float* __restrict__ omegas, const T* __restrict__ dy,
                   const T* __restrict__ y, const float* __restrict__ den,
                   T* __restrict__ dq, float* __restrict__ da_out,
                   float* __restrict__ dw_out, BwdDims dims, PsiConsts c) {
  constexpr int TT = kTile;
  extern __shared__ float smem[];
  const int L = dims.L, d = dims.d, m = dims.m;
  const BwdLayout lay = bwd_layout(d, DV, m, c.P, c.D, c.R);
  float* S = smem + lay.off_s;      // (m, lds), z right after it
  float* z = smem + lay.off_z;
  float* u = smem + lay.off_u;
  float* aw = smem + lay.off_aw;
  float* phi = smem + lay.off_phi;
  float* psi = smem + lay.off_psi;  // rows 0..T-1 Ψq (then dΨq), T.. Ψk
  float* vs = smem + lay.off_v;
  float* gs = smem + lay.off_g;
  float* hs = smem + lay.off_h;
  float* dp = smem + lay.off_dp;
  float* pa = smem + lay.off_pa;
  float* inv = smem + lay.off_inv;
  float* daw = smem + lay.off_daw;
  float* dpsiq = psi;
  const float* psik = psi + TT * lay.ldp;
  const int ldp = lay.ldp, lds = lay.lds, ldsc = lay.ldsc;
  const int h = blockIdx.x, hk = h / dims.G;

  bwd_init(S, m * lds + m, daw, (c.P + c.D) * d, aw, lay.ldw, anchors,
           omegas, d, c);

  for (int t0 = 0; t0 < L; t0 += TT) {
    bwd_load_tile<T, DV>(q, k, v, dy, y, den, h, hk, t0, dims, lay, u, vs, gs,
                         hs);
    __syncthreads();
    psi_rows<true>(u, lay.ldu, 2 * TT, d, aw, lay.ldw, phi, psi, ldp, c, pa,
                   inv);
    tile_dp<DV>(gs, hs, vs, nullptr, nullptr, ldp, m, ldsc, dp, nullptr);
    // Ψq is not read again, so dΨq replaces it.
    tile_dpsi_q<DV>(S, lds, z, gs, hs, dp, ldsc, psik, ldp, m,
                    [&](int t, int f, float x) { dpsiq[t * ldp + f] = x; });
    __syncthreads();
    psi_bwd_rows(u, lay.ldu, TT, d, aw, lay.ldw, phi, pa, inv, dpsiq, ldp,
                 smem + lay.off_dproj, daw, c);
    bwd_store_rows(dq, h, t0, L, d, u, lay.ldu);
    // Only now: S += Ψkᵀ V, z += Σ Ψk.
    scan_update<DV>(S, lds, z, psik, ldp, vs, nullptr, m);
  }
  store_daw(daw, da_out, dw_out, h, d, c);
}

// K4: reverse scan -> per-q-head dk, dv and the k-path dA/dΩ partials.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 1)
fused_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ anchors,
                    const float* __restrict__ omegas, const T* __restrict__ dy,
                    const T* __restrict__ y, const float* __restrict__ den,
                    T* __restrict__ dk, T* __restrict__ dv_out,
                    float* __restrict__ da_out, float* __restrict__ dw_out,
                    BwdDims dims, PsiConsts c) {
  constexpr int TT = kTile;
  extern __shared__ float smem[];
  const int L = dims.L, d = dims.d, m = dims.m;
  const BwdLayout lay = bwd_layout(d, DV, m, c.P, c.D, c.R);
  float* dS = smem + lay.off_s;     // (m, lds), dz right after it
  float* dz = smem + lay.off_z;
  float* u = smem + lay.off_u;
  float* aw = smem + lay.off_aw;
  float* phi = smem + lay.off_phi;
  float* psi = smem + lay.off_psi;  // rows 0..T-1 Ψq, T.. Ψk (then dΨk)
  float* vs = smem + lay.off_v;
  float* gs = smem + lay.off_g;
  float* hs = smem + lay.off_h;
  float* sc = smem + lay.off_sc;
  float* dp = smem + lay.off_dp;
  float* pa = smem + lay.off_pa;
  float* inv = smem + lay.off_inv;
  float* daw = smem + lay.off_daw;
  const float* psiq = psi;
  float* psik = psi + TT * lay.ldp;
  const int ldp = lay.ldp, lds = lay.lds, ldsc = lay.ldsc;
  const int h = blockIdx.x, hk = h / dims.G;

  bwd_init(dS, m * lds + m, daw, (c.P + c.D) * d, aw, lay.ldw, anchors,
           omegas, d, c);
  const int ntiles = (L + TT - 1) / TT;

  for (int tile = ntiles - 1; tile >= 0; --tile) {
    const int t0 = tile * TT;
    bwd_load_tile<T, DV>(q, k, v, dy, y, den, h, hk, t0, dims, lay, u, vs, gs,
                         hs);
    __syncthreads();
    psi_rows<true>(u, lay.ldu, 2 * TT, d, aw, lay.ldw, phi, psi, ldp, c, pa,
                   inv);
    tile_dp<DV>(gs, hs, vs, psiq, psik, ldp, m, ldsc, dp, sc);
    tile_dv<T, DV>(psik, ldp, dS, lds, sc, ldsc, gs, m, dv_out, h, L, t0);
    __syncthreads();
    // Ψk has been read, so dΨk replaces it.
    tile_dpsi_k<DV>(dS, lds, dz, vs, dp, ldsc, psiq, ldp, m,
                    [&](int s2, int f, float x) { psik[s2 * ldp + f] = x; });
    __syncthreads();
    psi_bwd_rows(u + TT * lay.ldu, lay.ldu, TT, d, aw, lay.ldw,
                 phi + TT * lay.ldphi, pa + TT * c.P, inv + TT, psik, ldp,
                 smem + lay.off_dproj, daw, c);
    bwd_store_rows(dk, h, t0, L, d, u + TT * lay.ldu, lay.ldu);
    // Only now: dS += Ψqᵀ G, dz += Ψqᵀ h.
    scan_update<DV>(dS, lds, dz, psiq, ldp, gs, hs, m);
  }
  store_daw(daw, da_out, dw_out, h, d, c);
}

struct BwdArgs {
  const void *q, *k, *v, *dy, *y;
  const float *anchors, *omegas, *den;
  void *dq_or_dk, *dv;
  float *da, *dw;
};

template <typename T, int DV>
int launch_bwd(bool kv, const BwdArgs& a, int bh, const BwdDims& dims,
               const PsiConsts& c, size_t smem, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dy = static_cast<const T*>(a.dy);
  const T* y = static_cast<const T*>(a.y);
  cudaError_t err;
  if (kv) {
    auto kern = fused_bwd_kv_kernel<T, DV>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<bh, kThreads, smem, stream>>>(
        q, k, v, a.anchors, a.omegas, dy, y, a.den,
        static_cast<T*>(a.dq_or_dk), static_cast<T*>(a.dv), a.da, a.dw, dims,
        c);
  } else {
    auto kern = fused_bwd_q_kernel<T, DV>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<bh, kThreads, smem, stream>>>(
        q, k, v, a.anchors, a.omegas, dy, y, a.den,
        static_cast<T*>(a.dq_or_dk), a.da, a.dw, dims, c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd_dv(int dv, bool kv, const BwdArgs& a, int bh,
                    const BwdDims& dims, const PsiConsts& c, size_t smem,
                    cudaStream_t stream) {
  switch (dv) {
    case 16: return launch_bwd<T, 16>(kv, a, bh, dims, c, smem, stream);
    case 32: return launch_bwd<T, 32>(kv, a, bh, dims, c, smem, stream);
    case 64: return launch_bwd<T, 64>(kv, a, bh, dims, c, smem, stream);
    case 128: return launch_bwd<T, 128>(kv, a, bh, dims, c, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

inline long long bwd_smem_bytes(int d, int dv, int P, int D, int R) {
  return (long long)bwd_layout(d, dv, R * P * D, P, D, R).total * 4;
}

// Checks, constants and dispatch shared by the two C entry points.
inline int run_bwd(bool kv, const BwdArgs& a, int bh, int bk, int L, int d,
                   int dv, int P, int D, int R, const double* s_nodes,
                   const double* sqrt_w, float delta, int dtype,
                   void* stream) {
  if (bk <= 0 || bh % bk || R < 1 || R > kMaxNodes || L < 0 || d < 1 ||
      d > 32 * kMaxDPerLane)
    return (int)cudaErrorInvalidValue;
  const PsiConsts c = make_psi_consts(P, D, R, s_nodes, sqrt_w);
  const BwdDims dims{L, d, bh / bk, R * P * D, delta};
  const size_t smem = (size_t)bwd_smem_bytes(d, dv, P, D, R);
  auto st = static_cast<cudaStream_t>(stream);
  if (bh == 0) return 0;
  if (dtype == 0)
    return dispatch_bwd_dv<float>(dv, kv, a, bh, dims, c, smem, st);
  if (dtype == 1)
    return dispatch_bwd_dv<__nv_bfloat16>(dv, kv, a, bh, dims, c, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace slay

extern "C" {

// Bytes of dynamic shared memory one block of K3 or K4 needs.
long long slay_fused_bwd_smem_bytes(int d, int dv, int P, int D, int R) {
  return slay::bwd_smem_bytes(d, dv, P, D, R);
}

// K3. q (bh, L, d), k (bk, L, d), v (bk, L, dv), dy and y (bh, L, dv) in
// fp32 (dtype 0) or bf16 (dtype 1); anchors (P, d), omegas (D, d) and den
// (bh, L) fp32; s_nodes, sqrt_w: R host doubles. Writes dq (bh, L, d) in
// the input dtype and this kernel's dA (bh, P, d), dΩ (bh, D, d) partials
// in fp32. Returns a cudaError_t code (0 = launched).
int slay_fused_bwd_q(const void* q, const void* k, const void* v,
                     const void* anchors, const void* omegas, const void* dy,
                     const void* y, const void* den, void* dq, void* da,
                     void* dw, int bh, int bk, int L, int d, int dv, int P,
                     int D, int R, const double* s_nodes, const double* sqrt_w,
                     float delta, int dtype, void* stream) {
  const slay::BwdArgs a{q, k, v, dy, y,
                        static_cast<const float*>(anchors),
                        static_cast<const float*>(omegas),
                        static_cast<const float*>(den), dq, nullptr,
                        static_cast<float*>(da), static_cast<float*>(dw)};
  return slay::run_bwd(false, a, bh, bk, L, d, dv, P, D, R, s_nodes, sqrt_w,
                        delta, dtype, stream);
}

// K4. Inputs as K3. Writes per-q-head dk (bh, L, d) and dv (bh, L, dv) in
// the input dtype and this kernel's dA, dΩ partials in fp32.
int slay_fused_bwd_kv(const void* q, const void* k, const void* v,
                      const void* anchors, const void* omegas, const void* dy,
                      const void* y, const void* den, void* dk, void* dv_out,
                      void* da, void* dw, int bh, int bk, int L, int d, int dv,
                      int P, int D, int R, const double* s_nodes,
                      const double* sqrt_w, float delta, int dtype,
                      void* stream) {
  const slay::BwdArgs a{q, k, v, dy, y,
                        static_cast<const float*>(anchors),
                        static_cast<const float*>(omegas),
                        static_cast<const float*>(den), dk, dv_out,
                        static_cast<float*>(da), static_cast<float*>(dw)};
  return slay::run_bwd(true, a, bh, bk, L, d, dv, P, D, R, s_nodes, sqrt_w,
                        delta, dtype, stream);
}

}  // extern "C"
