// Fused causal SLAY attention forward for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel repro/kernels/slay_fused.py::_fwd_kernel (B1).
// For each q row h (kv row h / G) it walks the sequence in tiles of 16
// tokens and, per tile,
//
//   Ψq, Ψk  = Ψ(q_tile), Ψ(k_tile)                 (shared memory only)
//   num     = Ψq·S + tril(Ψq Ψkᵀ)·V,  den = Ψq·z + rowsum(tril(Ψq Ψkᵀ))
//   y       = num / (den + δ),  den written without δ (backward residual)
//   S      += Ψkᵀ V,  z += Σ Ψk                   (fp32, shared memory)
//
// Ψ never touches device memory. The TPU kernel's sequential chunk grid
// axis becomes the tile loop inside one block; chunking is only an order
// of evaluation, so any tile gives the same result up to rounding.
//
// One block per (q row h, quadrature node r): a grid of BH x R blocks (144
// at the serving shape BH = 48, 288 at the training shape BH = 96, against
// one block per q row before). Ψ = concat_r √w_r (φ_p ⊗ φ_e,r), so every
// sum over Ψ's columns above splits exactly by node: block (h, r) computes
// Ψ for node r's P·D columns only (psi_rows with a node range and the
// one-node thread mappings of K3 and K4), carries node r's (S_r, z_r) and
// forms node r's shares num_r = Ψq_r S_r + tril(Ψq_r Ψk_rᵀ) V and den_r =
// Ψq_r z_r + rowsum(tril(Ψq_r Ψk_rᵀ)). It writes them in fp32 to a node
// axis, num (R, BH, L, dv) and den (R, BH, L), and a second kernel, the
// epilogue (scan_tile_mma.cuh::fwd_epilogue, which B5 launches too), sums
// the R shares in the order r = 0, 1, ... and writes y = Σ num_r / (Σ
// den_r + δ) in the input dtype and den = Σ den_r in fp32 (no atomics:
// the result does not depend on block order). The C entry launches both.
//
// What bounds it: operations. Per token and q head it does the Ψ map of
// its q row and, per kv head, of its k row, ≈ 2·m·dv for the read-out Ψq S
// and as much for the carry update, against ≈ 3·d + dv values of traffic.
// The scores, the read-out (Ψq S and the scores times V) and the carry
// update run on the tensor cores as mma.sync in 3xTF32
// (scan_tile_mma.cuh), which keeps fp32 accuracy; Ψ and Ψq·z stay on the
// fp32 pipes. The next tile's raw q, k and v rows are copied with cp.async
// while the current one computes (16-byte copies where the rows allow,
// narrower ones otherwise). P·D is padded to a multiple of 16 columns with
// zeros in shared memory, so the kernel takes every shape it took before.
//
// Shared memory at slayformer shapes (d = dv = 64, P·D = 128), bf16: the
// node's fp32 carry (34.8 KB), Ψ of the tile's 2 x 16 rows for one node
// (16.9 KB), raw and normalised rows, projections, φ, V, the scores and
// the staging buffer of the next tile (6.1 KB; 12.3 KB in fp32): 81.6 KB,
// so 2 blocks per SM; the 288 blocks of the training shape take 264 slots
// and a second wave.
#include <cstdint>

#include "scan_tile_mma.cuh"

namespace slay {

struct FusedDims {
  int L, d, G, pd;   // pd: P·D rounded up to a multiple of 16
  float delta;
};

// Shared-memory carve-up (floats, each offset 16-byte aligned), then the
// staging bytes. Strides are padded by 4 floats so that the MMA fragments'
// reads fall on different banks.
struct FusedLayout {
  int ldu, ldw, ldp, ldphi, ldc, ldv, ldsc, ldsq, ldsv;
  int off_c, off_z, off_u, off_aw, off_phi, off_psi, off_v, off_sc, off_schi,
      off_stage;
  int total_bytes;
};

__host__ __device__ inline FusedLayout fused_layout(int d, int dv, int P,
                                                    int D, int es) {
  constexpr int T = kMmaTile;
  const int pd = pad16(P * D);
  FusedLayout l;
  l.ldu = d + 4;   // 16-byte rows for psi_rows's float4 projections
  l.ldw = d + 4;
  l.ldp = pd + 4;
  l.ldphi = P + D;
  l.ldc = dv + 4;
  l.ldv = dv + 4;
  l.ldsc = T + 4;
  l.ldsq = pad16(d * es);    // staged row strides in bytes
  l.ldsv = pad16(dv * es);
  int o = 0;
  l.off_c = carve(o, pd * l.ldc);
  l.off_z = carve(o, pd);
  l.off_u = carve(o, 2 * T * l.ldu);
  l.off_aw = carve(o, (P + D) * l.ldw);
  l.off_phi = carve(o, 2 * T * l.ldphi);
  l.off_psi = carve(o, 2 * T * l.ldp);
  l.off_v = carve(o, T * l.ldv);
  l.off_sc = carve(o, T * l.ldsc);
  l.off_schi = carve(o, T * l.ldsc);
  l.off_stage = o;
  l.total_bytes = o * 4 + T * (2 * l.ldsq + l.ldsv);
  return l;
}

// Start copying tile t0's raw q and k rows and v rows into the staging
// buffer (q rows, then k rows, then v rows); rows past L are zero-filled.
// One commit group. No wait, no sync.
template <typename T, int DV>
__device__ inline void fwd_stage(const T* q, const T* k, const T* v, int h,
                                 int hk, int t0, const FusedDims& dims,
                                 const FusedLayout& lay, char* stage) {
  constexpr int TT = kMmaTile;
  const int L = dims.L, d = dims.d, es = (int)sizeof(T);
  const int nvalid = L - t0 < TT ? L - t0 : TT;
  const int64_t oq = (int64_t)h * L + t0, ok = (int64_t)hk * L + t0;
  stage_rows(stage, lay.ldsq, reinterpret_cast<const char*>(q + oq * d),
             (int64_t)d * es, d * es, nvalid);
  stage_rows(stage + TT * lay.ldsq, lay.ldsq,
             reinterpret_cast<const char*>(k + ok * d), (int64_t)d * es,
             d * es, nvalid);
  stage_rows(stage + 2 * TT * lay.ldsq, lay.ldsv,
             reinterpret_cast<const char*>(v + ok * DV), (int64_t)DV * es,
             DV * es, nvalid);
  cp_async_commit();
}

// K1: the forward scan of node blockIdx.y of q row blockIdx.x -> the
// node's shares of num and den.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 2)
fused_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ anchors,
                 const float* __restrict__ omegas, float* __restrict__ num,
                 float* __restrict__ den, FusedDims dims,
                 const __grid_constant__ PsiConsts c) {
  constexpr int TT = kMmaTile;
  extern __shared__ __align__(16) float smem[];
  const int L = dims.L, d = dims.d, pd = dims.pd;
  const FusedLayout lay = fused_layout(d, DV, c.P, c.D, sizeof(T));
  float* S = smem + lay.off_c;
  float* z = smem + lay.off_z;
  float* u = smem + lay.off_u;          // rows 0..T-1 q, T..2T-1 k
  float* aw = smem + lay.off_aw;
  float* phi = smem + lay.off_phi;
  float* psiq = smem + lay.off_psi;     // rows 0..T-1 Ψq, T..2T-1 Ψk
  const float* psik = psiq + TT * lay.ldp;
  float* vs = smem + lay.off_v;
  float* sc = smem + lay.off_sc;
  float* sc_hi = smem + lay.off_schi;
  char* stage = reinterpret_cast<char*>(smem + lay.off_stage);
  const int h = blockIdx.x, hk = h / dims.G, r = blockIdx.y;
  const int64_t prow = (int64_t)r * gridDim.x + h;   // (node, q row)

  // Zero the carry and Ψ (whose columns past P·D psi_rows never writes).
  for (int i = threadIdx.x; i < lay.off_u; i += kThreads) smem[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * TT * lay.ldp; i += kThreads) psiq[i] = 0.f;
  load_projections(anchors, omegas, d, c, aw, lay.ldw);
  const int ntiles = (L + TT - 1) / TT;
  if (ntiles > 0) fwd_stage<T, DV>(q, k, v, h, hk, 0, dims, lay, stage);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * TT;
    cp_async_wait_all();
    __syncthreads();
    const T* sq = reinterpret_cast<const T*>(stage);
    unstage_rows(sq, lay.ldsq / (int)sizeof(T), 2 * TT, d, d, u, lay.ldu);
    unstage_rows(reinterpret_cast<const T*>(stage + 2 * TT * lay.ldsq),
                 lay.ldsv / (int)sizeof(T), TT, DV, DV, vs, lay.ldv);
    __syncthreads();
    if (tile + 1 < ntiles)
      fwd_stage<T, DV>(q, k, v, h, hk, t0 + TT, dims, lay, stage);
    psi_rows<false, true>(u, lay.ldu, 2 * TT, d, aw, lay.ldw, phi, psiq,
                          lay.ldp, c, nullptr, nullptr, r, 1);
    mma_dp_scores<DV, false>(nullptr, nullptr, lay.ldv, nullptr, psiq, psik,
                             lay.ldp, pd, nullptr, sc, sc_hi, lay.ldsc);
    __syncthreads();
    mma_readout<DV>(psiq, lay.ldp, S, lay.ldc, z, sc, sc_hi, lay.ldsc, vs,
                    lay.ldv, pd, num, den, prow, t0, L);
    __syncthreads();
    // Only now: S += Ψkᵀ V, z += Σ Ψk.
    mma_update<DV>(S, lay.ldc, z, psik, lay.ldp, vs, lay.ldv, nullptr, pd);
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  const float *anchors, *omegas;
  void* y;
  float *den, *num_part, *den_part;
};

template <typename T, int DV>
int launch_fused(const FwdArgs& a, int bh, const FusedDims& dims,
                 const PsiConsts& c, cudaStream_t stream) {
  auto kern = fused_fwd_kernel<T, DV>;
  const size_t smem = fused_layout(dims.d, DV, c.P, c.D, sizeof(T)).total_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, c.R);   // one block per (q row, quadrature node)
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.anchors, a.omegas, a.num_part, a.den_part,
      dims, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_fwd_epilogue(a.num_part, a.den_part, static_cast<T*>(a.y),
                             a.den, (int64_t)bh * dims.L, DV, c.R, dims.delta,
                             stream);
}

template <typename T>
int dispatch_dv(int dv, const FwdArgs& a, int bh, const FusedDims& dims,
                const PsiConsts& c, cudaStream_t stream) {
#define SLAY_FWD_DV(N) \
  case N:              \
    return launch_fused<T, N>(a, bh, dims, c, stream);
  switch (dv) {
    SLAY_FWD_DV(16)
    SLAY_FWD_DV(32)
    SLAY_FWD_DV(64)
    SLAY_FWD_DV(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SLAY_FWD_DV
}

// Residency of the (T, DV) kernel at these shapes (kernel_residency).
template <typename T>
int occupancy_fused(int d, int dv, int P, int D, int* out) {
#define SLAY_FWD_DV(N)                                                  \
  case N:                                                               \
    return kernel_residency(                                            \
        reinterpret_cast<const void*>(fused_fwd_kernel<T, N>),          \
        fused_layout(d, N, P, D, sizeof(T)).total_bytes, out);
  switch (dv) {
    SLAY_FWD_DV(16)
    SLAY_FWD_DV(32)
    SLAY_FWD_DV(64)
    SLAY_FWD_DV(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SLAY_FWD_DV
}

}  // namespace slay

extern "C" {

// Bytes of dynamic shared memory one block needs at these shapes (fp32,
// the larger staging buffer; a block holds one node, whatever R).
long long slay_fused_smem_bytes(int d, int dv, int P, int D) {
  return slay::fused_layout(d, dv, P, D, 4).total_bytes;
}

// q (bh, L, d), k (bk, L, d), v (bk, L, dv) in fp32 (dtype 0) or bf16
// (dtype 1); anchors (P, d), omegas (D, d) fp32; s_nodes, sqrt_w: R host
// doubles; num_part (R, bh, L, dv) and den_part (R, bh, L) fp32 scratch
// for the node shares. Launches K1 on a bh x R grid, then the epilogue,
// which writes y (bh, L, dv) in the input dtype and den (bh, L) fp32.
// Returns a cudaError_t code (0 = launched).
int slay_fused_fwd(const void* q, const void* k, const void* v,
                   const void* anchors, const void* omegas, void* y, void* den,
                   void* num_part, void* den_part, int bh, int bk, int L,
                   int d, int dv, int P, int D, int R, const double* s_nodes,
                   const double* sqrt_w, float delta, int dtype,
                   void* stream) {
  if (bk <= 0 || bh % bk || R < 1 || R > slay::kMaxNodes || L < 0 || d < 1)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || L == 0) return 0;
  const slay::FwdArgs a{q, k, v,
                        static_cast<const float*>(anchors),
                        static_cast<const float*>(omegas), y,
                        static_cast<float*>(den),
                        static_cast<float*>(num_part),
                        static_cast<float*>(den_part)};
  const slay::PsiConsts c =
      slay::make_psi_consts(P, D, R, s_nodes, sqrt_w);
  const slay::FusedDims dims{L, d, bh / bk, slay::pad16(P * D), delta};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return slay::dispatch_dv<float>(dv, a, bh, dims, c, st);
  if (dtype == 1)
    return slay::dispatch_dv<__nv_bfloat16>(dv, a, bh, dims, c, st);
  return (int)cudaErrorInvalidValue;
}

// Residency of K1 on the current card for these shapes, as
// slay_fused_bwd_occupancy reports K3's and K4's. Returns a cudaError_t
// code.
int slay_fused_fwd_occupancy(int d, int dv, int P, int D, int dtype,
                             int* out) {
  if (dtype == 0) return slay::occupancy_fused<float>(d, dv, P, D, out);
  if (dtype == 1)
    return slay::occupancy_fused<__nv_bfloat16>(d, dv, P, D, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
