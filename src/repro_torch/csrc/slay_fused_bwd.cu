// Fused causal SLAY attention backward for Hopper (sm_90a): K3 and K4.
//
// Replace the TPU kernels repro/kernels/slay_fused.py::_bwd_q_kernel (B2)
// and ::_bwd_kv_kernel (B3). Both recompute everything from raw q/k/v, as
// the forward (K1, slay_fused.cu) does, and walk the TPU's sequential
// chunk axis as a loop over 16-token tiles. With G = dy/(den+δ) and
// h = −Σ(dy∘y)/(den+δ) per token and dP = tril(G Vᵀ + h 1ᵀ) per tile:
//
// K3 (B2) walks the tiles forward and carries (S, z) as K1 does:
//   dΨq = G Sᵀ + h zᵀ + dP Ψk  (S, z of the tiles before this one)
//   dq, dA, dΩ = Ψ-VJP(dΨq);   then S += Ψkᵀ V, z += Σ Ψk
// K4 (B3) walks the tiles in reverse and carries (dS, dz):
//   dV  = tril(Ψq Ψkᵀ)ᵀ G + Ψk dS
//   dΨk = dPᵀ Ψq + V dSᵀ + 1 dzᵀ  (dS, dz of the tiles after this one)
//   dk, dA, dΩ = Ψ-VJP(dΨk);   then dS += Ψqᵀ G, dz += Ψqᵀ h
//
// One block per (q row h, quadrature node r): a grid of BH x R blocks
// (288 at slayformer-124m's training shape, against 96 for one block per
// q row). Ψ = concat_r √w_r (φ_p ⊗ φ_e,r) and every product above either
// reduces over Ψ's columns or touches them one by one, so block (h, r)
// carries only node r's P·D rows of the state, computes Ψ for node r's
// columns only (psi_rows with a node range; the normalisation and the
// P + D projections are repeated per node) and forms node r's share of dq
// (K3), or of dk and dv (K4), and of dA, dΩ: dP is recomputed by every
// node, the scores tril(Ψq Ψkᵀ) enter dV through their node part, and the
// Ψ VJP is linear in dΨ, so the shares add up to the whole. Each block
// writes its shares in fp32 to a node axis of its outputs, (R, BH, L, ·)
// and (R, BH, P|D, d), and the wrapper sums that axis (no atomics: the
// result does not depend on block order). The wrapper returns per-q-head
// dq (BH, L, d), dk (BH, L, d) and dv (BH, L, dv) in the input dtype and
// dA (BH, P, d), dΩ (BH, D, d) in fp32, and sums dk and dv over each GQA
// group and dA, dΩ over heads and both kernels.
//
// What bounds them: operations. Per token and q head each does the Ψ maps
// of its q and k rows, ≈ 2·m·dv per state product (G Sᵀ; or Ψk dS and
// V dSᵀ) and the carry update, against ≈ 6 values of traffic per token
// and feature column. The state products, the tile products (dP, the
// scores, dP Ψk or dPᵀ Ψq, scoresᵀ G) and the carry update run on the
// tensor cores as mma.sync in 3xTF32 (scan_tile_mma.cuh), which keeps fp32
// accuracy; the Ψ map and its VJP stay on the fp32 pipes (slay_common.cuh,
// the one Ψ of every kernel), with thread mappings for a one-node block.
// The next tile's raw q, k, v, dy, y and den are copied with cp.async
// while the current one computes.
//
// Shared memory at slayformer shapes (d = dv = 64, P·D = 128), bf16: the
// node's fp32 carry (34.8 KB), Ψ of the tile's 2 x 16 rows for one node
// (16.9 KB), raw and normalised rows, G, V, dA/dΩ sums, K4's scores, dP
// and dv share, and the staging buffer of the next tile (10.3 KB; 20.5 KB
// in fp32): 98.4 KB for K3 and 104.8 KB for K4, so 2 blocks per SM and
// 264 of the 288 blocks resident at once. A third block per SM would need
// under 76.8 KB and 80 registers a thread: that is the carry, Ψ and the
// staging buffer with little else.
#include <cstdint>

#include "scan_tile_mma.cuh"

namespace slay {

struct BwdDims {
  int L, d, G, pd;
  float delta;
};

// Shared-memory carve-up (floats), then the staging bytes. Strides are
// padded by 4 floats so that the MMA fragments' reads fall on different
// banks; the staging buffer starts 16-byte aligned.
struct BwdLayout {
  int ldu, ldw, ldp, ldphi, ldc, ldv, ldsc;
  int off_c, off_z, off_u, off_aw, off_phi, off_pa, off_inv, off_psi, off_v,
      off_g, off_h, off_sc, off_schi, off_dp, off_dproj, off_daw, off_dv,
      off_stage;
  int stage_bytes, total_bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int d, int dv, int P, int D,
                                                bool kv, int es) {
  constexpr int T = kMmaTile;
  const int pd = P * D;
  BwdLayout l;
  l.ldu = d + 4;   // 16-byte rows for psi_rows's float4 projections
  l.ldw = d + 4;
  l.ldp = pd + 4;
  l.ldphi = P + D;
  l.ldc = dv + 4;
  l.ldv = dv + 4;
  l.ldsc = T + 4;
  int o = 0;
  l.off_c = o;     o += pd * l.ldc;
  l.off_z = o;     o += pd;
  l.off_u = o;     o += 2 * T * l.ldu;
  l.off_aw = o;    o += (P + D) * l.ldw;
  l.off_phi = o;   o += 2 * T * l.ldphi;
  l.off_pa = o;    o += 2 * T * P;
  l.off_inv = o;   o += 2 * T;
  l.off_psi = o;   o += 2 * T * l.ldp;
  l.off_v = o;     o += T * l.ldv;
  l.off_g = o;     o += T * l.ldv;
  l.off_h = o;     o += T;
  // dproj (the Ψ VJP's scratch) reuses K4's sc, sc_hi and dp, dead by then.
  const int nsc = kv ? 3 * T * l.ldsc : 0;
  l.off_sc = o;
  l.off_schi = o + T * l.ldsc;
  l.off_dp = o + 2 * T * l.ldsc;
  l.off_dproj = o;
  o += nsc > T * (P + D) ? nsc : T * (P + D);
  l.off_daw = o;   o += (P + D) * d;
  l.off_dv = o;    o += kv ? T * dv : 0;
  o = (o + 3) / 4 * 4;
  l.off_stage = o;
  l.stage_bytes = T * (2 * d + 3 * dv) * es + T * 4;
  l.total_bytes = o * 4 + l.stage_bytes;
  return l;
}

// Start copying tile t0's raw q, k rows (d each), v, dy, y rows (DV each)
// and den into the staging buffer, in that order; rows past L are
// zero-filled. One commit group. No wait, no sync.
template <typename T, int DV>
__device__ inline void bwd_stage(const T* q, const T* k, const T* v,
                                 const T* dy, const T* y, const float* den,
                                 int h, int hk, int t0, const BwdDims& dims,
                                 char* stage) {
  constexpr int TT = kMmaTile;
  const int L = dims.L, d = dims.d;
  const int nvalid = L - t0 < TT ? L - t0 : TT;
  const int rq = d * (int)sizeof(T), rv = DV * (int)sizeof(T);
  const int64_t oq = (int64_t)h * L + t0, ok = (int64_t)hk * L + t0;
  char* o = stage;
  stage_rows<true>(o, rq, reinterpret_cast<const char*>(q + oq * d), rq, rq,
                   nvalid);
  o += TT * rq;
  stage_rows<true>(o, rq, reinterpret_cast<const char*>(k + ok * d), rq, rq,
                   nvalid);
  o += TT * rq;
  stage_rows<true>(o, rv, reinterpret_cast<const char*>(v + ok * DV), rv, rv,
                   nvalid);
  o += TT * rv;
  stage_rows<true>(o, rv, reinterpret_cast<const char*>(dy + oq * DV), rv, rv,
                   nvalid);
  o += TT * rv;
  stage_rows<true>(o, rv, reinterpret_cast<const char*>(y + oq * DV), rv, rv,
                   nvalid);
  o += TT * rv;
  stage_rows(o, 4, reinterpret_cast<const char*>(den + oq), 4, 4, nvalid);
  cp_async_commit();
}

// The staged tile to fp32: raw q rows (0..T-1) and k rows (T..2T-1) of u,
// v, and the cotangents G = dy/e, h = −Σ(dy∘y)/e with e = den + δ
// (unstage_cotangents). Zero rows past L give zero Ψ, G and h, so they
// add nothing. No sync.
template <typename T, int DV>
__device__ inline void bwd_unstage(const char* stage, const BwdDims& dims,
                                   const BwdLayout& lay, float* u, float* vs,
                                   float* gs, float* hs) {
  constexpr int TT = kMmaTile;
  const int d = dims.d;
  const T* sq = reinterpret_cast<const T*>(stage);   // q rows, then k rows
  const T* sv = sq + 2 * TT * d;
  const T* sdy = sv + TT * DV;
  const T* sy = sdy + TT * DV;
  const float* sden = reinterpret_cast<const float*>(sy + TT * DV);
  unstage_rows<true>(sq, d, 2 * TT, d, d, u, lay.ldu);
  unstage_rows<true>(sv, DV, TT, DV, DV, vs, lay.ldv);
  unstage_cotangents<T, DV>(sdy, sy, sden, dims.delta, gs, lay.ldv, hs);
}

// Block-wide set-up: zero the carry and the dA/dΩ sums, stage anchors and
// omegas. No sync.
__device__ inline void bwd_init(float* smem, const BwdLayout& lay, int pd,
                                int d, const float* anchors,
                                const float* omegas, const PsiConsts& c) {
  for (int i = threadIdx.x; i < pd * lay.ldc + pd; i += blockDim.x)
    smem[lay.off_c + i] = 0.f;   // carry, then carry_z right after it
  for (int i = threadIdx.x; i < (c.P + c.D) * d; i += blockDim.x)
    smem[lay.off_daw + i] = 0.f;
  load_projections(anchors, omegas, d, c, smem + lay.off_aw, lay.ldw);
}

// K3: forward re-scan of node blockIdx.y -> dq and the q-path dA/dΩ.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 2)
fused_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ anchors,
                   const float* __restrict__ omegas, const T* __restrict__ dy,
                   const T* __restrict__ y, const float* __restrict__ den,
                   float* __restrict__ dq_part, float* __restrict__ da_part,
                   float* __restrict__ dw_part, BwdDims dims,
                   const __grid_constant__ PsiConsts c) {
  constexpr int TT = kMmaTile;
  extern __shared__ __align__(16) float smem[];
  const int L = dims.L, d = dims.d, pd = dims.pd;
  const BwdLayout lay = bwd_layout(d, DV, c.P, c.D, false, sizeof(T));
  float* S = smem + lay.off_c;
  float* z = smem + lay.off_z;
  float* u = smem + lay.off_u;
  const float* aw = smem + lay.off_aw;
  float* phi = smem + lay.off_phi;
  float* pa = smem + lay.off_pa;
  float* inv = smem + lay.off_inv;
  float* psiq = smem + lay.off_psi;   // dΨq (K3 forms no Ψq)
  const float* psik = psiq + TT * lay.ldp;
  float* vs = smem + lay.off_v;
  float* gs = smem + lay.off_g;
  float* hs = smem + lay.off_h;
  float* daw = smem + lay.off_daw;
  char* stage = reinterpret_cast<char*>(smem + lay.off_stage);
  const int h = blockIdx.x, hk = h / dims.G, r = blockIdx.y;
  const int64_t prow = (int64_t)r * gridDim.x + h;   // (node, q row)

  bwd_init(smem, lay, pd, d, anchors, omegas, c);
  const int ntiles = (L + TT - 1) / TT;
  if (ntiles > 0) bwd_stage<T, DV>(q, k, v, dy, y, den, h, hk, 0, dims, stage);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * TT;
    cp_async_wait_all();
    __syncthreads();
    bwd_unstage<T, DV>(stage, dims, lay, u, vs, gs, hs);
    __syncthreads();
    if (tile + 1 < ntiles)
      bwd_stage<T, DV>(q, k, v, dy, y, den, h, hk, t0 + TT, dims, stage);
    // Ψq is never read (dΨq takes its place): Ψ of the k rows only.
    psi_rows<true, true>(u, lay.ldu, 2 * TT, d, aw, lay.ldw, phi, psiq,
                         lay.ldp, c, pa, inv, r, 1, TT);
    // dΨq goes to Ψq's rows.
    mma_dpsi_q<DV>(S, lay.ldc, z, gs, vs, lay.ldv, hs, psik, lay.ldp, pd,
                   psiq);
    __syncthreads();
    psi_bwd_rows<true>(u, lay.ldu, TT, d, aw, lay.ldw, phi, pa, inv, psiq,
                       lay.ldp, smem + lay.off_dproj, daw, c, r, 1);
    store_share(u, lay.ldu, d, dq_part, prow, t0, L);
    // Only now: S += Ψkᵀ V, z += Σ Ψk.
    mma_update<DV>(S, lay.ldc, z, psik, lay.ldp, vs, lay.ldv, nullptr, pd);
  }
  store_daw(daw, da_part, dw_part, (int)prow, d, c);
}

// K4: reverse scan of node blockIdx.y -> per-q-head dk, dv and the k-path
// dA/dΩ.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 2)
fused_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ anchors,
                    const float* __restrict__ omegas, const T* __restrict__ dy,
                    const T* __restrict__ y, const float* __restrict__ den,
                    float* __restrict__ dk_part, float* __restrict__ dv_part,
                    float* __restrict__ da_part, float* __restrict__ dw_part,
                    BwdDims dims, const __grid_constant__ PsiConsts c) {
  constexpr int TT = kMmaTile;
  extern __shared__ __align__(16) float smem[];
  const int L = dims.L, d = dims.d, pd = dims.pd;
  const BwdLayout lay = bwd_layout(d, DV, c.P, c.D, true, sizeof(T));
  float* dS = smem + lay.off_c;
  float* dz = smem + lay.off_z;
  float* u = smem + lay.off_u;
  const float* aw = smem + lay.off_aw;
  float* phi = smem + lay.off_phi;
  float* pa = smem + lay.off_pa;
  float* inv = smem + lay.off_inv;
  const float* psiq = smem + lay.off_psi;
  float* psik = smem + lay.off_psi + TT * lay.ldp;   // Ψk, then dΨk
  float* vs = smem + lay.off_v;
  float* gs = smem + lay.off_g;
  float* hs = smem + lay.off_h;
  float* sc = smem + lay.off_sc;
  float* sc_hi = smem + lay.off_schi;
  float* dp = smem + lay.off_dp;
  float* daw = smem + lay.off_daw;
  float* dvs = smem + lay.off_dv;
  char* stage = reinterpret_cast<char*>(smem + lay.off_stage);
  const int h = blockIdx.x, hk = h / dims.G, r = blockIdx.y;
  const int64_t prow = (int64_t)r * gridDim.x + h;   // (node, q row)

  bwd_init(smem, lay, pd, d, anchors, omegas, c);
  const int ntiles = (L + TT - 1) / TT;
  if (ntiles > 0)
    bwd_stage<T, DV>(q, k, v, dy, y, den, h, hk, (ntiles - 1) * TT, dims,
                     stage);

  for (int tile = ntiles - 1; tile >= 0; --tile) {
    const int t0 = tile * TT;
    cp_async_wait_all();
    __syncthreads();
    bwd_unstage<T, DV>(stage, dims, lay, u, vs, gs, hs);
    __syncthreads();
    if (tile > 0)
      bwd_stage<T, DV>(q, k, v, dy, y, den, h, hk, t0 - TT, dims, stage);
    psi_rows<true, true>(u, lay.ldu, 2 * TT, d, aw, lay.ldw, phi,
                   smem + lay.off_psi, lay.ldp, c, pa, inv, r, 1);
    mma_dp_scores<DV>(gs, vs, lay.ldv, hs, psiq, psik, lay.ldp, pd, dp, sc,
                      sc_hi, lay.ldsc);
    __syncthreads();
    mma_dv<DV>(sc, sc_hi, lay.ldsc, gs, lay.ldv, psik, lay.ldp, dS, lay.ldc,
               pd, dvs);
    __syncthreads();
    // Ψk has been read, so dΨk replaces it.
    mma_dpsi_k<DV>(dS, lay.ldc, dz, vs, lay.ldv, dp, lay.ldsc, psiq, lay.ldp,
                   pd, psik);
    __syncthreads();
    psi_bwd_rows<true>(u + TT * lay.ldu, lay.ldu, TT, d, aw, lay.ldw,
                       phi + TT * lay.ldphi, pa + TT * c.P, inv + TT, psik,
                       lay.ldp, smem + lay.off_dproj, daw, c, r, 1);
    store_share(u + TT * lay.ldu, lay.ldu, d, dk_part, prow, t0, L);
    store_share(dvs, DV, DV, dv_part, prow, t0, L);
    // Only now: dS += Ψqᵀ G, dz += Ψqᵀ h.
    mma_update<DV>(dS, lay.ldc, dz, psiq, lay.ldp, gs, lay.ldv, hs, pd);
  }
  store_daw(daw, da_part, dw_part, (int)prow, d, c);
}

struct BwdArgs {
  const void *q, *k, *v, *dy, *y;
  const float *anchors, *omegas, *den;
  float *out0, *out1;   // K3: dq partials; K4: dk and dv partials
  float *da, *dw;
};

// The kernel for (kv, T, DV) with its dynamic shared memory allowed.
template <typename T, int DV>
const void* bwd_kernel(bool kv) {
  return kv ? reinterpret_cast<const void*>(fused_bwd_kv_kernel<T, DV>)
            : reinterpret_cast<const void*>(fused_bwd_q_kernel<T, DV>);
}

template <typename T, int DV>
int launch_bwd(bool kv, const BwdArgs& a, int bh, const BwdDims& dims,
               const PsiConsts& c, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dy = static_cast<const T*>(a.dy);
  const T* y = static_cast<const T*>(a.y);
  const size_t smem =
      bwd_layout(dims.d, DV, c.P, c.D, kv, sizeof(T)).total_bytes;
  const void* fn = bwd_kernel<T, DV>(kv);
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, c.R);   // one block per (q row, quadrature node)
  if (kv)
    fused_bwd_kv_kernel<T, DV><<<grid, kThreads, smem, stream>>>(
        q, k, v, a.anchors, a.omegas, dy, y, a.den, a.out0, a.out1, a.da,
        a.dw, dims, c);
  else
    fused_bwd_q_kernel<T, DV><<<grid, kThreads, smem, stream>>>(
        q, k, v, a.anchors, a.omegas, dy, y, a.den, a.out0, a.da, a.dw, dims,
        c);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd_dv(int dv, bool kv, const BwdArgs& a, int bh,
                    const BwdDims& dims, const PsiConsts& c,
                    cudaStream_t stream) {
#define SLAY_BWD_DV(N) \
  case N:              \
    return launch_bwd<T, N>(kv, a, bh, dims, c, stream);
  switch (dv) {
    SLAY_BWD_DV(16)
    SLAY_BWD_DV(32)
    SLAY_BWD_DV(64)
    SLAY_BWD_DV(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SLAY_BWD_DV
}

// The shapes K3 and K4 take (d a multiple of 8 up to the lanes' reach,
// P·D a multiple of 16).
inline bool bwd_shapes_ok(int d, int P, int D) {
  return d >= 8 && d % 8 == 0 && d <= 32 * kMaxDPerLane && (P * D) % 16 == 0;
}

// Checks, constants and dispatch shared by the C entry points.
inline int run_bwd(bool kv, const BwdArgs& a, int bh, int bk, int L, int d,
                   int dv, int P, int D, int R, const double* s_nodes,
                   const double* sqrt_w, float delta, int dtype,
                   void* stream) {
  if (bk <= 0 || bh % bk || R < 1 || R > kMaxNodes || L < 0 ||
      !bwd_shapes_ok(d, P, D))
    return (int)cudaErrorInvalidValue;
  const PsiConsts c = make_psi_consts(P, D, R, s_nodes, sqrt_w);
  const BwdDims dims{L, d, bh / bk, P * D, delta};
  auto st = static_cast<cudaStream_t>(stream);
  if (bh == 0) return 0;
  if (dtype == 0) return dispatch_bwd_dv<float>(dv, kv, a, bh, dims, c, st);
  if (dtype == 1)
    return dispatch_bwd_dv<__nv_bfloat16>(dv, kv, a, bh, dims, c, st);
  return (int)cudaErrorInvalidValue;
}

// Residency of the (kv, T, DV) kernel at these shapes (kernel_residency).
template <typename T>
int occupancy_bwd(bool kv, int d, int dv, int P, int D, int* out) {
#define SLAY_BWD_DV(N)                                                   \
  case N:                                                                \
    return kernel_residency(                                             \
        bwd_kernel<T, N>(kv),                                            \
        bwd_layout(d, N, P, D, kv, sizeof(T)).total_bytes, out);
  switch (dv) {
    SLAY_BWD_DV(16)
    SLAY_BWD_DV(32)
    SLAY_BWD_DV(64)
    SLAY_BWD_DV(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SLAY_BWD_DV
}

}  // namespace slay

extern "C" {

// Bytes of dynamic shared memory one block of K3 or K4 needs at most
// (K4 in fp32; a block holds one node, whatever R).
long long slay_fused_bwd_smem_bytes(int d, int dv, int P, int D) {
  return slay::bwd_layout(d, dv, P, D, true, 4).total_bytes;
}

// K3. q (bh, L, d), k (bk, L, d), v (bk, L, dv), dy and y (bh, L, dv) in
// fp32 (dtype 0) or bf16 (dtype 1), 16-byte aligned, d a multiple of 8,
// P·D a multiple of 16; anchors (P, d), omegas (D, d) and den (bh, L)
// fp32; s_nodes, sqrt_w: R host doubles. Writes each quadrature node's
// share of dq, (R, bh, L, d), and of this kernel's dA (R, bh, P, d) and
// dΩ (R, bh, D, d) partials, all fp32; their sum over the node axis is
// the backward. Grid bh x R. Returns a cudaError_t code (0 = launched).
int slay_fused_bwd_q(const void* q, const void* k, const void* v,
                     const void* anchors, const void* omegas, const void* dy,
                     const void* y, const void* den, void* dq, void* da,
                     void* dw, int bh, int bk, int L, int d, int dv, int P,
                     int D, int R, const double* s_nodes, const double* sqrt_w,
                     float delta, int dtype, void* stream) {
  const slay::BwdArgs a{q, k, v, dy, y,
                        static_cast<const float*>(anchors),
                        static_cast<const float*>(omegas),
                        static_cast<const float*>(den),
                        static_cast<float*>(dq), nullptr,
                        static_cast<float*>(da), static_cast<float*>(dw)};
  return slay::run_bwd(false, a, bh, bk, L, d, dv, P, D, R, s_nodes,
                       sqrt_w, delta, dtype, stream);
}

// K4. Inputs as K3. Writes each node's share of the per-q-head dk (R, bh,
// L, d) and dv (R, bh, L, dv) and of this kernel's dA, dΩ partials, fp32.
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
                        static_cast<const float*>(den),
                        static_cast<float*>(dk), static_cast<float*>(dv_out),
                        static_cast<float*>(da), static_cast<float*>(dw)};
  return slay::run_bwd(true, a, bh, bk, L, d, dv, P, D, R, s_nodes,
                       sqrt_w, delta, dtype, stream);
}

// Residency of K3 (kv = 0) or K4 (kv = 1) on the current card for these
// shapes, from the CUDA occupancy calculator and the kernel's attributes:
// out[0] blocks per SM, out[1] blocks resident at once, out[2] registers
// per thread, out[3] local-memory (spill) bytes per thread, out[4] shared
// memory per block, out[5] tokens per tile. Returns a cudaError_t code.
int slay_fused_bwd_occupancy(int kv, int d, int dv, int P, int D, int dtype,
                             int* out) {
  if (!slay::bwd_shapes_ok(d, P, D)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return slay::occupancy_bwd<float>(kv != 0, d, dv, P, D, out);
  if (dtype == 1)
    return slay::occupancy_bwd<__nv_bfloat16>(kv != 0, d, dv, P, D, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
