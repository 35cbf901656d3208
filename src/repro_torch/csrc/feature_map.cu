// The SLAY feature map Ψ(u) and its VJP for Hopper (sm_90a): B7 and B8.
//
// Replace the TPU kernels repro/kernels/feature_map.py::_kernel (B7) and
// ::_bwd_kernel (B8), the first dispatch of the two-dispatch path (the
// feature map writes Ψ to device memory, slay_scan.cu reads it back).
// Both run psi_rows from slay_common.cuh, the Ψ that K1, K3 and K4
// compute inside their scans, so the fused and the two-dispatch paths
// share one feature map as common.py is shared on the TPU.
//
// Tiles of kFmTile tokens of the flat (N, d) input; N need not be a
// multiple of anything (the last tile's rows past N are zero and never
// stored). No padding, no atomics:
//
//   B7: one block per tile; Ψ of the tile's rows, written (N, m) in u's
//       dtype.
//   B8: a persistent grid of as many blocks as the card holds at once
//       (slay_feature_map_bwd_blocks), each walking the tiles
//       blockIdx.x, blockIdx.x + gridDim.x, ...: Ψ recomputed with
//       psi_rows<true> (keeping inv and pa), dΨ rows loaded over the
//       recomputed Ψ, then psi_bwd_rows, which adds the tile's dA and dΩ
//       to the block's sums in shared memory. du (N, d) in u's dtype per
//       tile, and one row of dA (P, d) and of dΩ (D, d) per block, fp32,
//       which the wrapper sums: a few hundred partials, not one per tile.
//
// What bounds them: bytes. Per token B7 reads d values and writes
// m = R·P·D (384 at slayformer shapes) while doing ≈ 2·d·(P + D) + 2·m
// operations; B8 reads d + m and writes d. This first version stages the
// tile in shared memory as fp32 and runs Ψ's arithmetic on the fp32 pipes;
// vector stores and a larger tile are later work.
#include <cstdint>

#include "slay_common.cuh"

namespace slay {

constexpr int kFmTile = 32;   // tokens per block

// Shared-memory carve-up (floats); each offset is a row count times a
// padded stride.
struct FmLayout {
  int ldu, ldw, ldp, ldphi;
  int off_u, off_aw, off_phi, off_psi, off_pa, off_inv, off_dproj, off_daw;
  int total;
};

__host__ __device__ inline FmLayout fm_layout(int d, int m, int P, int D,
                                              int R, bool bwd) {
  constexpr int T = kFmTile;
  FmLayout l;
  l.ldu = d + 1;
  l.ldw = d + 1;
  l.ldp = m + 1;
  l.ldphi = P + R * D;
  int o = 0;
  l.off_u = o;     o += T * l.ldu;
  l.off_aw = o;    o += (P + D) * l.ldw;
  l.off_phi = o;   o += T * l.ldphi;
  l.off_psi = o;   o += T * l.ldp;
  l.off_pa = o;    o += bwd ? T * P : 0;
  l.off_inv = o;   o += bwd ? T : 0;
  l.off_dproj = o; o += bwd ? T * (P + D) : 0;
  l.off_daw = o;   o += bwd ? (P + D) * d : 0;
  l.total = o;
  return l;
}

// The tile's raw rows to fp32 shared memory, zero past n. No sync.
template <typename T>
__device__ inline void fm_load(const T* u, int n, int t0, int d,
                               const FmLayout& lay, float* us) {
  for (int i = threadIdx.x; i < kFmTile * d; i += blockDim.x) {
    const int t = i / d, col = i % d;
    us[t * lay.ldu + col] =
        t0 + t < n ? to_f32(u[((int64_t)t0 + t) * d + col]) : 0.f;
  }
}

// B7: Ψ(u) of one tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
feature_map_fwd_kernel(const T* __restrict__ u,
                       const float* __restrict__ anchors,
                       const float* __restrict__ omegas, T* __restrict__ psi,
                       int n, int d, PsiConsts c) {
  extern __shared__ float smem[];
  const int m = c.R * c.P * c.D;
  const FmLayout lay = fm_layout(d, m, c.P, c.D, c.R, false);
  float* us = smem + lay.off_u;
  float* aw = smem + lay.off_aw;
  float* ps = smem + lay.off_psi;
  const int t0 = blockIdx.x * kFmTile;
  fm_load(u, n, t0, d, lay, us);
  load_projections(anchors, omegas, d, c, aw, lay.ldw);
  __syncthreads();
  psi_rows(us, lay.ldu, kFmTile, d, aw, lay.ldw, smem + lay.off_phi, ps,
           lay.ldp, c);
  for (int i = threadIdx.x; i < kFmTile * m; i += blockDim.x) {
    const int t = i / m, col = i % m;
    if (t0 + t < n)
      psi[((int64_t)t0 + t) * m + col] = from_f32<T>(ps[t * lay.ldp + col]);
  }
}

// B8: du of every tile this block walks, and the block's dA, dΩ sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
feature_map_bwd_kernel(const T* __restrict__ u,
                       const float* __restrict__ anchors,
                       const float* __restrict__ omegas,
                       const T* __restrict__ dpsi, T* __restrict__ du,
                       float* __restrict__ da_out, float* __restrict__ dw_out,
                       int n, int d, PsiConsts c) {
  extern __shared__ float smem[];
  const int m = c.R * c.P * c.D;
  const FmLayout lay = fm_layout(d, m, c.P, c.D, c.R, true);
  float* us = smem + lay.off_u;
  float* aw = smem + lay.off_aw;
  float* phi = smem + lay.off_phi;
  float* ps = smem + lay.off_psi;
  float* pa = smem + lay.off_pa;
  float* inv = smem + lay.off_inv;
  float* daw = smem + lay.off_daw;
  const int ntiles = (n + kFmTile - 1) / kFmTile;
  for (int i = threadIdx.x; i < (c.P + c.D) * d; i += blockDim.x) daw[i] = 0.f;
  load_projections(anchors, omegas, d, c, aw, lay.ldw);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int t0 = tile * kFmTile;
    fm_load(u, n, t0, d, lay, us);
    __syncthreads();
    psi_rows<true>(us, lay.ldu, kFmTile, d, aw, lay.ldw, phi, ps, lay.ldp, c,
                   pa, inv);
    // dΨ over the recomputed Ψ, which the VJP does not read.
    for (int i = threadIdx.x; i < kFmTile * m; i += blockDim.x) {
      const int t = i / m, col = i % m;
      ps[t * lay.ldp + col] =
          t0 + t < n ? to_f32(dpsi[((int64_t)t0 + t) * m + col]) : 0.f;
    }
    __syncthreads();
    psi_bwd_rows(us, lay.ldu, kFmTile, d, aw, lay.ldw, phi, pa, inv, ps,
                 lay.ldp, smem + lay.off_dproj, daw, c);
    for (int i = threadIdx.x; i < kFmTile * d; i += blockDim.x) {
      const int t = i / d, col = i % d;
      if (t0 + t < n)
        du[((int64_t)t0 + t) * d + col] = from_f32<T>(us[t * lay.ldu + col]);
    }
    __syncthreads();   // us is the next tile's
  }
  store_daw(daw, da_out, dw_out, blockIdx.x, d, c);
}

// B7 (bwd false) or B8 with its dynamic shared memory allowed; null if
// the attribute cannot be set.
template <typename T>
const void* fm_kernel(bool bwd, size_t smem) {
  const void* kern =
      bwd ? reinterpret_cast<const void*>(feature_map_bwd_kernel<T>)
          : reinterpret_cast<const void*>(feature_map_fwd_kernel<T>);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return nullptr;
  return kern;
}

inline size_t fm_smem(int d, int P, int D, int R, bool bwd) {
  return (size_t)fm_layout(d, R * P * D, P, D, R, bwd).total * sizeof(float);
}

// B8's persistent grid on the current device: the blocks that fit on all
// SMs at once, at most one per tile. Negative cudaError_t on failure.
template <typename T>
int fm_bwd_blocks(int n, int d, int P, int D, int R) {
  const size_t smem = fm_smem(d, P, D, R, true);
  const void* kern = fm_kernel<T>(true, smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = kern == nullptr ? cudaErrorInvalidValue : cudaSuccess;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  const int ntiles = (n + kFmTile - 1) / kFmTile;
  const int full = sms * (per_sm > 0 ? per_sm : 1);
  return ntiles < full ? ntiles : full;
}

template <typename T>
int launch_fm(bool bwd, const void* u, const float* anchors,
              const float* omegas, const void* dpsi, void* out, float* da,
              float* dw, int n, int d, int blocks, const PsiConsts& c,
              size_t smem, cudaStream_t stream) {
  const void* kern = fm_kernel<T>(bwd, smem);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  if (bwd)
    feature_map_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(u), anchors, omegas, static_cast<const T*>(dpsi),
        static_cast<T*>(out), da, dw, n, d, c);
  else
    feature_map_fwd_kernel<T><<<(n + kFmTile - 1) / kFmTile, kThreads, smem,
                                stream>>>(static_cast<const T*>(u), anchors,
                                          omegas, static_cast<T*>(out), n, d,
                                          c);
  return (int)cudaGetLastError();
}

inline int run_fm(bool bwd, const void* u, const void* anchors,
                  const void* omegas, const void* dpsi, void* out, void* da,
                  void* dw, int n, int d, int blocks, int P, int D, int R,
                  const double* s_nodes, const double* sqrt_w, int dtype,
                  void* stream) {
  if (R < 1 || R > kMaxNodes || n < 0 || d < 1 ||
      (bwd && (d > 32 * kMaxDPerLane || blocks < (n > 0 ? 1 : 0))))
    return (int)cudaErrorInvalidValue;
  const PsiConsts c = make_psi_consts(P, D, R, s_nodes, sqrt_w);
  const size_t smem = fm_smem(d, P, D, R, bwd);
  auto a = static_cast<const float*>(anchors);
  auto w = static_cast<const float*>(omegas);
  auto pda = static_cast<float*>(da);
  auto pdw = static_cast<float*>(dw);
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (dtype == 0)
    return launch_fm<float>(bwd, u, a, w, dpsi, out, pda, pdw, n, d, blocks, c,
                            smem, st);
  if (dtype == 1)
    return launch_fm<__nv_bfloat16>(bwd, u, a, w, dpsi, out, pda, pdw, n, d,
                                    blocks, c, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace slay

extern "C" {

// Bytes of dynamic shared memory one block of B7 (bwd 0) or B8 (bwd 1)
// needs at these shapes.
long long slay_feature_map_smem_bytes(int d, int P, int D, int R, int bwd) {
  return (long long)slay::fm_smem(d, P, D, R, bwd != 0);
}

// Blocks of B8's persistent grid for n tokens on the current device, and
// so the rows of its dA/dΩ partials; a negative cudaError_t on failure.
int slay_feature_map_bwd_blocks(int n, int d, int P, int D, int R,
                                int dtype) {
  if (dtype == 0) return slay::fm_bwd_blocks<float>(n, d, P, D, R);
  if (dtype == 1) return slay::fm_bwd_blocks<__nv_bfloat16>(n, d, P, D, R);
  return -(int)cudaErrorInvalidValue;
}

// B7. u (n, d) in fp32 (dtype 0) or bf16 (dtype 1); anchors (P, d),
// omegas (D, d) fp32; s_nodes, sqrt_w: R host doubles. Writes psi
// (n, R·P·D) in u's dtype. Returns a cudaError_t code (0 = launched).
int slay_feature_map_fwd(const void* u, const void* anchors,
                         const void* omegas, void* psi, int n, int d, int P,
                         int D, int R, const double* s_nodes,
                         const double* sqrt_w, int dtype, void* stream) {
  return slay::run_fm(false, u, anchors, omegas, nullptr, psi, nullptr,
                      nullptr, n, d, 0, P, D, R, s_nodes, sqrt_w, dtype,
                      stream);
}

// B8 on `blocks` blocks (slay_feature_map_bwd_blocks). u as B7 and dpsi
// (n, R·P·D) in u's dtype. Writes du (n, d) in u's dtype and, per block,
// one dA (P, d) and one dΩ (D, d) partial in fp32.
int slay_feature_map_bwd(const void* u, const void* anchors,
                         const void* omegas, const void* dpsi, void* du,
                         void* da, void* dw, int n, int d, int blocks, int P,
                         int D, int R, const double* s_nodes,
                         const double* sqrt_w, int dtype, void* stream) {
  return slay::run_fm(true, u, anchors, omegas, dpsi, du, da, dw, n, d,
                      blocks, P, D, R, s_nodes, sqrt_w, dtype, stream);
}

}  // extern "C"
