// Causal linear attention on precomputed features for Hopper (sm_90a):
// B5, B6a and B6b, the scan of the two-dispatch path.
//
// Replace the TPU kernels repro/kernels/slay_scan.py::_kernel (B5),
// ::_bwd_q_kernel (B6a) and ::_bwd_kv_kernel (B6b). They are K1, K3 and
// K4 (slay_fused.cu, slay_fused_bwd.cu) with Ψ read from device memory
// (written there by feature_map.cu) instead of computed, and without the
// chain through Ψ. The TPU's sequential chunk axis becomes a loop over
// 16-token tiles inside a block, with the carry in fp32 shared memory. Ψ
// tiles arrive in bf16 or fp32 and are widened to fp32 in shared memory.
// With G = dy/(den+δ), h = −Σ(dy∘y)/(den+δ) per token and dP = tril(G Vᵀ +
// h 1ᵀ) per tile:
//
// B5 walks the tiles forward, reading (S, z) before adding the tile:
//   num = Ψq S + tril(Ψq Ψkᵀ) V,  den = Ψq z + rowsum(tril(Ψq Ψkᵀ))
//   y = num / (den + δ) in v's dtype, den (without δ) fp32;
//   then S += Ψkᵀ V, z += Σ Ψk
// B6a walks forward with (S, z) as B5 does:
//   dΨq = G Sᵀ + h zᵀ + dP Ψk;  then S += Ψkᵀ V, z += Σ Ψk
// B6b walks in reverse, reading (dS, dz) before adding the tile:
//   dV  = tril(Ψq Ψkᵀ)ᵀ G + Ψk dS,  dΨk = dPᵀ Ψq + V dSᵀ + 1 dzᵀ;
//   then dS += Ψqᵀ G, dz += Ψqᵀ h
// tril keeps the diagonal.
//
// What bounds them: operations. Per token and q head each does ≈ 2·m·dv
// for every state term (B5 two, B6a two, B6b four) against ≈ 2 bytes per
// feature column in bf16, so ≈ 100 operations per byte.
//
// All three run one block per (q row h, slice c of kScanSlice = 128
// feature columns): a grid of BH x C blocks, C = ceil(m / 128) (288 at the
// training shape, BH = 96 and m = 384; 144 at the serving shape, BH = 48).
// Every sum over Ψ's columns splits exactly by slice, so block (h, c)
// carries only its slice's (S_c, z_c) or (dS_c, dz_c), from kv row h / G:
//   B5 writes the slice's shares num_c = Ψq_c S_c + tril(Ψq_c Ψk_cᵀ) V
//     and den_c = Ψq_c z_c + rowsum(tril(Ψq_c Ψk_cᵀ)) in fp32 to a slice
//     axis, num (C, BH, L, dv) and den (C, BH, L); K1's epilogue
//     (scan_tile_mma.cuh::fwd_epilogue) sums them in the order c = 0, 1,
//     ... and writes y and den (no atomics). The C entry launches both.
//   B6a writes dΨq_c = G S_cᵀ + dP Ψk_c + h z_cᵀ, the slice's own columns
//     of dq, in the input dtype; dP does not depend on the slice, and
//     every block recomputes it in registers.
//   B6b writes dΨk_c = dPᵀ Ψq_c + V dS_cᵀ + dz_c, the slice's columns of
//     dk, in the input dtype, and its share dV_c = tril(Ψq_c Ψk_cᵀ)ᵀ G +
//     Ψk_c dS_c in fp32 to a slice axis (C, BH, L, dv) that the wrapper
//     sums, then over each GQA group (no atomics).
// Their tile and state products run on the tensor cores as mma.sync in
// 3xTF32 with the phases of K1 (B5), K3 (B6a) and K4 (B6b) in
// scan_tile_mma.cuh. The next tile's Ψq and Ψk slices (B6a reads no Ψq),
// v and, in the backward, dy, y and den are copied with cp.async while the
// current one computes (16-byte copies where the rows allow, narrower ones
// otherwise). The last slice of an m that 128 does not divide is padded
// with zero columns in shared memory, which add nothing.
//
// Shared memory at slayformer shapes (m = 384, dv = 64), bf16 inputs: the
// slice's fp32 carry (34.8 KB), the Ψ tiles (16.9 KB; B6a's Ψq buffer
// takes its dΨq), V and what the kernel needs of G, h, the scores, dP and
// the dV share, and the staging buffer: B5 69376 B, B6a 71296 B, B6b
// 83328 B (fp32 inputs: 79616, 81536, 97664 B), checked on the host
// against the 227 KB a block may have. B5 and B6b keep 2 blocks per SM
// (115 and 110 registers; built for 3, B5 spills); B6a fits 3.
#include <cstdint>

#include "scan_tile_mma.cuh"

namespace slay {

enum ScanKind { kScanFwd = 0, kScanBwdQ = 1, kScanBwdKV = 2 };
constexpr int kScanSlice = 128;   // feature columns per block

struct ScanDims {
  int L, G, m;
  float delta;
};

// One kernel's shared-memory carve-up (floats, each offset 16-byte
// aligned), then the staging bytes, for slices of pw = min(m, 128)
// columns rounded up to a multiple of 16; strides padded by 4 floats as in
// slay_fused_bwd.cu. Each kernel takes only what it uses: B6a's dΨq goes
// to the Ψq buffer and it has no scores; only B6b keeps dP and a dV share.
// Staged rows (byte offsets st_*): Ψq (not in B6a) at 0, then Ψk, v and,
// in the backward, dy, y and den.
struct ScanLayout {
  int pw, ldp, ldc, ldv, ldsc, ldsp, ldsv;
  int off_c, off_z, off_q, off_k, off_v, off_g, off_h, off_sc, off_schi,
      off_dp, off_dv, off_stage;
  int st_k, st_v, st_dy, st_y, st_den;
  int total_bytes;
};

__host__ __device__ inline ScanLayout scan_layout(int m, int dv, int es,
                                                  int kind) {
  constexpr int T = kMmaTile;
  const bool fwd = kind == kScanFwd, bwd_q = kind == kScanBwdQ;
  const bool kv = kind == kScanBwdKV;
  ScanLayout l;
  l.pw = pad16(m < kScanSlice ? m : kScanSlice);
  l.ldp = l.pw + 4;
  l.ldc = dv + 4;
  l.ldv = dv + 4;
  l.ldsc = T + 4;
  l.ldsp = l.pw * es;   // staged row strides in bytes
  l.ldsv = pad16(dv * es);
  int o = 0;
  l.off_c = carve(o, l.pw * l.ldc);
  l.off_z = carve(o, l.pw);
  l.off_q = carve(o, T * l.ldp);
  l.off_k = carve(o, T * l.ldp);
  l.off_v = carve(o, T * l.ldv);
  l.off_g = carve(o, fwd ? 0 : T * l.ldv);
  l.off_h = carve(o, fwd ? 0 : T);
  l.off_sc = carve(o, bwd_q ? 0 : T * l.ldsc);
  l.off_schi = carve(o, bwd_q ? 0 : T * l.ldsc);
  l.off_dp = carve(o, kv ? T * l.ldsc : 0);
  l.off_dv = carve(o, kv ? T * dv : 0);
  l.off_stage = o;
  int s = bwd_q ? 0 : T * l.ldsp;
  l.st_k = s;
  s += T * l.ldsp;
  l.st_v = s;
  s += T * l.ldsv;
  l.st_dy = s;
  l.st_y = s + (fwd ? 0 : T * l.ldsv);
  l.st_den = l.st_y + (fwd ? 0 : T * l.ldsv);
  l.total_bytes = o * 4 + l.st_den + (fwd ? 0 : T * 4);
  return l;
}

// Feature slices C for m feature columns: the grid's second axis.
__host__ __device__ inline int scan_slices(int m) {
  return (m + kScanSlice - 1) / kScanSlice;
}

// Start copying tile t0's rows into the staging buffer at the layout's
// offsets: slice columns f0..f0+mc-1 of Ψq (not in B6a) and Ψk, v and, in
// the backward, dy, y and den; rows past L are zero-filled. One commit
// group. No wait, no sync.
template <int Kind, typename T, int DV>
__device__ inline void scan_stage(const T* qf, const T* kf, const T* v,
                                  const T* dy, const T* y, const float* den,
                                  int h, int hk, int t0, int f0, int mc,
                                  const ScanDims& dims, const ScanLayout& lay,
                                  char* stage) {
  constexpr int TT = kMmaTile;
  const int L = dims.L, m = dims.m, es = (int)sizeof(T);
  const int nvalid = L - t0 < TT ? L - t0 : TT;
  const int64_t oq = (int64_t)h * L + t0, ok = (int64_t)hk * L + t0;
  const int64_t sp = (int64_t)m * es, sv = (int64_t)DV * es;
  if (Kind != kScanBwdQ)
    stage_rows(stage, lay.ldsp,
               reinterpret_cast<const char*>(qf + oq * m + f0), sp, mc * es,
               nvalid);
  stage_rows(stage + lay.st_k, lay.ldsp,
             reinterpret_cast<const char*>(kf + ok * m + f0), sp, mc * es,
             nvalid);
  stage_rows(stage + lay.st_v, lay.ldsv,
             reinterpret_cast<const char*>(v + ok * DV), sv, DV * es, nvalid);
  if (Kind != kScanFwd) {
    stage_rows(stage + lay.st_dy, lay.ldsv,
               reinterpret_cast<const char*>(dy + oq * DV), sv, DV * es,
               nvalid);
    stage_rows(stage + lay.st_y, lay.ldsv,
               reinterpret_cast<const char*>(y + oq * DV), sv, DV * es,
               nvalid);
    stage_rows(stage + lay.st_den, 4,
               reinterpret_cast<const char*>(den + oq), 4, 4, nvalid);
  }
  cp_async_commit();
}

// Widen the staged tile to fp32: the Ψq slice (not in B6a) to psiq and
// the Ψk slice to psik (16, ldp), both zero past the slice's mc columns up
// to pd; v to vs (16, ldv); in the backward, G to gs (16, ldv) and h to
// hs. No sync.
template <int Kind, typename T, int DV>
__device__ inline void scan_unstage(const char* stage, const ScanLayout& lay,
                                    int mc, int pd, float delta, float* psiq,
                                    float* psik, float* vs, float* gs,
                                    float* hs) {
  constexpr int TT = kMmaTile;
  if (Kind != kScanBwdQ)
    unstage_rows(reinterpret_cast<const T*>(stage), lay.pw, TT, mc, pd, psiq,
                 lay.ldp);
  unstage_rows(reinterpret_cast<const T*>(stage + lay.st_k), lay.pw, TT, mc,
               pd, psik, lay.ldp);
  unstage_rows(reinterpret_cast<const T*>(stage + lay.st_v),
               lay.ldsv / (int)sizeof(T), TT, DV, DV, vs, lay.ldv);
  if (Kind != kScanFwd)
    unstage_cotangents<T, DV>(
        reinterpret_cast<const T*>(stage + lay.st_dy),
        reinterpret_cast<const T*>(stage + lay.st_y),
        reinterpret_cast<const float*>(stage + lay.st_den), delta, gs,
        lay.ldv, hs);
}

// B5: the forward scan of slice blockIdx.y of q row blockIdx.x -> the
// slice's shares of num and den.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 2)
scan_fwd_kernel(const T* __restrict__ qf, const T* __restrict__ kf,
                const T* __restrict__ v, float* __restrict__ num,
                float* __restrict__ den, ScanDims dims) {
  constexpr int TT = kMmaTile;
  extern __shared__ __align__(16) float smem[];
  const int L = dims.L, m = dims.m;
  const ScanLayout lay = scan_layout(m, DV, sizeof(T), kScanFwd);
  float* S = smem + lay.off_c;
  float* z = smem + lay.off_z;
  float* psiq = smem + lay.off_q;
  float* psik = smem + lay.off_k;
  float* vs = smem + lay.off_v;
  float* sc = smem + lay.off_sc;
  float* sc_hi = smem + lay.off_schi;
  char* stage = reinterpret_cast<char*>(smem + lay.off_stage);
  const int h = blockIdx.x, hk = h / dims.G;
  const int f0 = blockIdx.y * kScanSlice;
  const int mc = m - f0 < kScanSlice ? m - f0 : kScanSlice;
  const int pd = pad16(mc);
  const int64_t prow = (int64_t)blockIdx.y * gridDim.x + h;   // (slice, row)

  for (int i = threadIdx.x; i < lay.off_q; i += kThreads) smem[i] = 0.f;
  const int ntiles = (L + TT - 1) / TT;
  if (ntiles > 0)
    scan_stage<kScanFwd, T, DV>(qf, kf, v, nullptr, nullptr, nullptr, h, hk,
                                0, f0, mc, dims, lay, stage);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * TT;
    cp_async_wait_all();
    __syncthreads();
    scan_unstage<kScanFwd, T, DV>(stage, lay, mc, pd, dims.delta, psiq, psik,
                                  vs, nullptr, nullptr);
    __syncthreads();
    if (tile + 1 < ntiles)
      scan_stage<kScanFwd, T, DV>(qf, kf, v, nullptr, nullptr, nullptr, h,
                                  hk, t0 + TT, f0, mc, dims, lay, stage);
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

// B6a: the forward re-scan of slice blockIdx.y of q row blockIdx.x -> the
// slice's columns of dq. Three blocks per SM: 79 registers and no spills,
// so the training shape's 288 blocks run in one wave.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 3)
scan_bwd_q_kernel(const T* __restrict__ kf, const T* __restrict__ v,
                  const T* __restrict__ dy, const T* __restrict__ y,
                  const float* __restrict__ den, T* __restrict__ dq,
                  ScanDims dims) {
  constexpr int TT = kMmaTile;
  extern __shared__ __align__(16) float smem[];
  const int L = dims.L, m = dims.m;
  const ScanLayout lay = scan_layout(m, DV, sizeof(T), kScanBwdQ);
  float* S = smem + lay.off_c;
  float* z = smem + lay.off_z;
  float* dpsi = smem + lay.off_q;       // dΨq of the tile
  float* psik = smem + lay.off_k;
  float* vs = smem + lay.off_v;
  float* gs = smem + lay.off_g;
  float* hs = smem + lay.off_h;
  char* stage = reinterpret_cast<char*>(smem + lay.off_stage);
  const int h = blockIdx.x, hk = h / dims.G;
  const int f0 = blockIdx.y * kScanSlice;
  const int mc = m - f0 < kScanSlice ? m - f0 : kScanSlice;
  const int pd = pad16(mc);

  for (int i = threadIdx.x; i < lay.off_q; i += kThreads) smem[i] = 0.f;
  const int ntiles = (L + TT - 1) / TT;
  if (ntiles > 0)
    scan_stage<kScanBwdQ, T, DV>(nullptr, kf, v, dy, y, den, h, hk, 0, f0, mc,
                                 dims, lay, stage);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * TT;
    cp_async_wait_all();
    __syncthreads();
    scan_unstage<kScanBwdQ, T, DV>(stage, lay, mc, pd, dims.delta, nullptr,
                                   psik, vs, gs, hs);
    __syncthreads();
    if (tile + 1 < ntiles)
      scan_stage<kScanBwdQ, T, DV>(nullptr, kf, v, dy, y, den, h, hk,
                                   t0 + TT, f0, mc, dims, lay, stage);
    mma_dpsi_q<DV>(S, lay.ldc, z, gs, vs, lay.ldv, hs, psik, lay.ldp, pd,
                   dpsi);
    __syncthreads();
    for (int i = threadIdx.x; i < TT * mc; i += kThreads) {
      const int t = i / mc, f = i % mc;
      if (t0 + t < L)
        dq[((int64_t)h * L + t0 + t) * m + f0 + f] =
            from_f32<T>(dpsi[t * lay.ldp + f]);
    }
    // Only now: S += Ψkᵀ V, z += Σ Ψk.
    mma_update<DV>(S, lay.ldc, z, psik, lay.ldp, vs, lay.ldv, nullptr, pd);
  }
}

// B6b: the reverse scan of slice blockIdx.y of q row blockIdx.x -> its
// columns of the per-q-head dΨk and its share of dV.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 2)
scan_bwd_kv_kernel(const T* __restrict__ qf, const T* __restrict__ kf,
                   const T* __restrict__ v, const T* __restrict__ dy,
                   const T* __restrict__ y, const float* __restrict__ den,
                   T* __restrict__ dk, float* __restrict__ dv_part,
                   ScanDims dims) {
  constexpr int TT = kMmaTile;
  extern __shared__ __align__(16) float smem[];
  const int L = dims.L, m = dims.m;
  const ScanLayout lay = scan_layout(m, DV, sizeof(T), kScanBwdKV);
  float* dS = smem + lay.off_c;
  float* dz = smem + lay.off_z;
  float* psiq = smem + lay.off_q;
  float* psik = smem + lay.off_k;       // Ψk, then dΨk
  float* vs = smem + lay.off_v;
  float* gs = smem + lay.off_g;
  float* hs = smem + lay.off_h;
  float* sc = smem + lay.off_sc;
  float* sc_hi = smem + lay.off_schi;
  float* dp = smem + lay.off_dp;
  float* dvs = smem + lay.off_dv;
  char* stage = reinterpret_cast<char*>(smem + lay.off_stage);
  const int h = blockIdx.x, hk = h / dims.G;
  const int f0 = blockIdx.y * kScanSlice;
  const int mc = m - f0 < kScanSlice ? m - f0 : kScanSlice;
  const int pd = pad16(mc);
  const int64_t prow = (int64_t)blockIdx.y * gridDim.x + h;   // (slice, row)

  for (int i = threadIdx.x; i < lay.off_q; i += kThreads) smem[i] = 0.f;
  const int ntiles = (L + TT - 1) / TT;
  if (ntiles > 0)
    scan_stage<kScanBwdKV, T, DV>(qf, kf, v, dy, y, den, h, hk,
                                  (ntiles - 1) * TT, f0, mc, dims, lay,
                                  stage);

  for (int tile = ntiles - 1; tile >= 0; --tile) {
    const int t0 = tile * TT;
    cp_async_wait_all();
    __syncthreads();
    scan_unstage<kScanBwdKV, T, DV>(stage, lay, mc, pd, dims.delta, psiq,
                                    psik, vs, gs, hs);
    __syncthreads();
    if (tile > 0)
      scan_stage<kScanBwdKV, T, DV>(qf, kf, v, dy, y, den, h, hk, t0 - TT, f0,
                                    mc, dims, lay, stage);
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
    for (int i = threadIdx.x; i < TT * mc; i += kThreads) {
      const int s2 = i / mc, f = i % mc;
      if (t0 + s2 < L)
        dk[((int64_t)h * L + t0 + s2) * m + f0 + f] =
            from_f32<T>(psik[s2 * lay.ldp + f]);
    }
    store_share(dvs, DV, DV, dv_part, prow, t0, L);
    // Only now: dS += Ψqᵀ G, dz += Ψqᵀ h.
    mma_update<DV>(dS, lay.ldc, dz, psiq, lay.ldp, gs, lay.ldv, hs, pd);
  }
}

struct ScanArgs {
  const void *qf, *kf, *v, *dy, *y;
  const float* den;
  void* out;         // y, dq or dk
  float* part;       // B5's num shares, B6b's dv shares (fp32)
  float *den_part, *den_out;   // B5's den shares and den
};

// The kernel of `kind` for (T, DV), as a pointer for the runtime API.
template <typename T, int DV>
const void* scan_kernel(int kind) {
  if (kind == kScanFwd)
    return reinterpret_cast<const void*>(scan_fwd_kernel<T, DV>);
  if (kind == kScanBwdQ)
    return reinterpret_cast<const void*>(scan_bwd_q_kernel<T, DV>);
  return reinterpret_cast<const void*>(scan_bwd_kv_kernel<T, DV>);
}

template <typename T, int DV>
int launch_scan(int kind, const ScanArgs& a, int bh, const ScanDims& dims,
                cudaStream_t stream) {
  const T* qf = static_cast<const T*>(a.qf);
  const T* kf = static_cast<const T*>(a.kf);
  const T* v = static_cast<const T*>(a.v);
  const T* dy = static_cast<const T*>(a.dy);
  const T* y = static_cast<const T*>(a.y);
  T* out = static_cast<T*>(a.out);
  const size_t smem = scan_layout(dims.m, DV, sizeof(T), kind).total_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T, DV>(kind), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, scan_slices(dims.m));   // one block per (row, slice)
  if (kind == kScanFwd) {
    scan_fwd_kernel<T, DV><<<grid, kThreads, smem, stream>>>(
        qf, kf, v, a.part, a.den_part, dims);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_fwd_epilogue(a.part, a.den_part, out, a.den_out,
                               (int64_t)bh * dims.L, DV, (int)grid.y,
                               dims.delta, stream);
  }
  if (kind == kScanBwdQ)
    scan_bwd_q_kernel<T, DV><<<grid, kThreads, smem, stream>>>(
        kf, v, dy, y, a.den, out, dims);
  else
    scan_bwd_kv_kernel<T, DV><<<grid, kThreads, smem, stream>>>(
        qf, kf, v, dy, y, a.den, out, a.part, dims);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_scan_dv(int dv, int kind, const ScanArgs& a, int bh,
                     const ScanDims& dims, cudaStream_t stream) {
#define SLAY_SCAN_DV(N) \
  case N:               \
    return launch_scan<T, N>(kind, a, bh, dims, stream);
  switch (dv) {
    SLAY_SCAN_DV(16)
    SLAY_SCAN_DV(32)
    SLAY_SCAN_DV(64)
    SLAY_SCAN_DV(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SLAY_SCAN_DV
}

// Checks and dispatch shared by the C entry points.
inline int run_scan(int kind, const ScanArgs& a, int bh, int bk, int L, int m,
                    int dv, float delta, int dtype, void* stream) {
  if (bk <= 0 || bh % bk || L < 0 || m < 1) return (int)cudaErrorInvalidValue;
  const ScanDims dims{L, bh / bk, m, delta};
  auto st = static_cast<cudaStream_t>(stream);
  if (bh == 0 || L == 0) return 0;
  if (dtype == 0) return dispatch_scan_dv<float>(dv, kind, a, bh, dims, st);
  if (dtype == 1)
    return dispatch_scan_dv<__nv_bfloat16>(dv, kind, a, bh, dims, st);
  return (int)cudaErrorInvalidValue;
}

// Residency of the (T, DV) kernel of `kind` for m feature columns
// (kernel_residency).
template <typename T>
int occupancy(int kind, int m, int dv, int* out) {
#define SLAY_SCAN_DV(N)                                                  \
  case N:                                                                \
    return kernel_residency(scan_kernel<T, N>(kind),                     \
                            scan_layout(m, N, sizeof(T), kind).total_bytes, \
                            out);
  switch (dv) {
    SLAY_SCAN_DV(16)
    SLAY_SCAN_DV(32)
    SLAY_SCAN_DV(64)
    SLAY_SCAN_DV(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SLAY_SCAN_DV
}

}  // namespace slay

extern "C" {

// Bytes of dynamic shared memory one block of B5 (kind 0), B6a (1) or
// B6b (2) needs (fp32 inputs, the larger staging buffer).
long long slay_scan_smem_bytes(int m, int dv, int kind) {
  return slay::scan_layout(m, dv, 4, kind).total_bytes;
}

// Feature slices C for m feature columns: every scan kernel's grid is
// bh x C.
int slay_scan_slices(int m) { return slay::scan_slices(m); }

// B5. qf (bh, L, m), kf (bk, L, m), v (bk, L, dv) in fp32 (dtype 0) or
// bf16 (dtype 1); num_part (C, bh, L, dv) and den_part (C, bh, L) fp32
// scratch for the slice shares, C = slay_scan_slices(m). Launches B5 on a
// bh x C grid, then the epilogue, which writes y (bh, L, dv) in the input
// dtype and den (bh, L) fp32. Returns a cudaError_t code (0 = launched).
int slay_scan_fwd(const void* qf, const void* kf, const void* v, void* y,
                  void* den, void* num_part, void* den_part, int bh, int bk,
                  int L, int m, int dv, float delta, int dtype,
                  void* stream) {
  const slay::ScanArgs a{qf, kf, v, nullptr, nullptr, nullptr, y,
                         static_cast<float*>(num_part),
                         static_cast<float*>(den_part),
                         static_cast<float*>(den)};
  return slay::run_scan(slay::kScanFwd, a, bh, bk, L, m, dv, delta,
                        dtype, stream);
}

// B6a. Inputs as B5 plus dy and y (bh, L, dv) in the input dtype and den
// (bh, L) fp32. Writes dq (bh, L, m) in the input dtype. Grid bh x C.
int slay_scan_bwd_q(const void* qf, const void* kf, const void* v,
                    const void* dy, const void* y, const void* den, void* dq,
                    int bh, int bk, int L, int m, int dv, float delta,
                    int dtype, void* stream) {
  const slay::ScanArgs a{qf, kf, v, dy, y, static_cast<const float*>(den), dq,
                         nullptr, nullptr, nullptr};
  return slay::run_scan(slay::kScanBwdQ, a, bh, bk, L, m, dv, delta,
                        dtype, stream);
}

// B6b. Inputs as B6a. Writes the per-q-head dk (bh, L, m) in the input
// dtype and each feature slice's share of the per-q-head dv, (C, bh, L,
// dv) fp32; their sum over the slice axis is dv. Grid bh x C.
int slay_scan_bwd_kv(const void* qf, const void* kf, const void* v,
                     const void* dy, const void* y, const void* den, void* dk,
                     void* dv_out, int bh, int bk, int L, int m, int dv,
                     float delta, int dtype, void* stream) {
  const slay::ScanArgs a{qf, kf, v, dy, y, static_cast<const float*>(den), dk,
                         static_cast<float*>(dv_out), nullptr, nullptr};
  return slay::run_scan(slay::kScanBwdKV, a, bh, bk, L, m, dv,
                        delta, dtype, stream);
}

// Residency of B5 (kind 0), B6a (1) or B6b (2) on the current card for
// these shapes, as slay_fused_bwd_occupancy reports K3's and K4's.
// Returns a cudaError_t code.
int slay_scan_occupancy(int kind, int m, int dv, int dtype, int* out) {
  if (m < 1 || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return slay::occupancy<float>(kind, m, dv, out);
  if (dtype == 1) return slay::occupancy<__nv_bfloat16>(kind, m, dv, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
