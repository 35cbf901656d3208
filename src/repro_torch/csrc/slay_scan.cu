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
// B5 and B6a are the first design: one block per q row h (kv row h / G),
// the phases of scan_tile.cuh on the fp32 pipes out of shared memory;
// shared memory at slayformer shapes (m = 384, dv = 64): B5 154 KB, B6a
// 135 KB of the 227 KB a block may have, checked on the host before
// launch.
//
// B6b runs one block per (q row h, slice c of kScanSlice = 128 feature
// columns): a grid of BH x C blocks, C = ceil(m / 128) (288 at the
// training shape, m = 384). dP does not depend on the slice and every
// block recomputes it; the scores enter dV through the slice's part
// tril(Ψq_c Ψk_cᵀ); dΨk's columns are the slice's own. So block (h, c)
// carries (dS_c, dz_c), writes dΨk_c = dPᵀ Ψq_c + V dS_cᵀ + dz_c exactly,
// in the input dtype, straight to dk's columns of the slice, and writes
// its share dV_c = tril(Ψq_c Ψk_cᵀ)ᵀ G + Ψk_c dS_c in fp32 to a slice axis
// (C, BH, L, dv) that the wrapper sums, then over each GQA group (no
// atomics). Its tile and state products run on the tensor cores as
// mma.sync in 3xTF32 with K4's phases (scan_tile_mma.cuh); the next tile's
// Ψq and Ψk slices, v, dy, y and den are copied with cp.async while the
// current one computes (16-byte copies where the rows allow, narrower
// ones otherwise). The last slice of an m that 128 does not divide is
// padded with zero columns in shared memory, which add nothing. Shared
// memory at slayformer shapes, bf16: the slice's fp32 carry (34.8 KB), Ψq
// and Ψk slices (16.9 KB), V, G, the scores, dP, the dV share and the
// staging buffer (14.4 KB; 28.7 KB in fp32): 83.3 KB, so 2 blocks per SM
// and 264 of the 288 blocks resident at once.
#include <cstdint>

#include "scan_tile.cuh"
#include "scan_tile_mma.cuh"

namespace slay {

enum ScanKind { kScanFwd = 0, kScanBwdQ = 1, kScanBwdKV = 2 };

struct ScanDims {
  int L, G, m;
  float delta;
};

// Shared-memory carve-up of B5 and B6a (floats); each takes only what it
// uses. B6a pads the carry's rows (lds = dv + 1) so that threads owning
// neighbouring features read different banks in the dΨ phase.
struct ScanLayout {
  int lds, ldp, ldsc;
  int off_s, off_z, off_q, off_k, off_v, off_g, off_h, off_sc, off_dp,
      off_den;
  int total;
};

__host__ __device__ inline ScanLayout scan_layout(int m, int dv, int kind) {
  constexpr int T = kTile;
  const bool fwd = kind == kScanFwd, bwd = !fwd;
  ScanLayout l;
  l.lds = bwd ? dv + 1 : dv;
  l.ldp = m + 1;
  l.ldsc = T + 1;
  int o = 0;
  l.off_s = o;   o += m * l.lds;
  l.off_z = o;   o += m;
  l.off_q = o;   o += fwd ? T * l.ldp : 0;
  l.off_k = o;   o += T * l.ldp;
  l.off_v = o;   o += T * dv;
  l.off_g = o;   o += bwd ? T * dv : 0;
  l.off_h = o;   o += bwd ? T : 0;
  l.off_sc = o;  o += fwd ? T * l.ldsc : 0;
  l.off_dp = o;  o += bwd ? T * l.ldsc : 0;
  l.off_den = o; o += fwd ? T : 0;
  l.total = o;
  return l;
}

// Rows t0..t0+T-1 of one (rows, L, width) tensor to fp32 shared memory
// with row stride ld; rows past L are zero (their Ψ is zero, so they add
// nothing to the state). No sync.
template <typename T>
__device__ inline void load_rows(const T* src, int row, int t0, int L,
                                 int width, float* dst, int ld) {
  for (int i = threadIdx.x; i < kTile * width; i += blockDim.x) {
    const int t = i / width, col = i % width;
    dst[t * ld + col] =
        t0 + t < L ? to_f32(src[((int64_t)row * L + t0 + t) * width + col])
                   : 0.f;
  }
}

// B5: y and den of q row h.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 1)
scan_fwd_kernel(const T* __restrict__ qf, const T* __restrict__ kf,
                const T* __restrict__ v, T* __restrict__ y,
                float* __restrict__ den_out, ScanDims dims) {
  extern __shared__ float smem[];
  const int L = dims.L, m = dims.m;
  const ScanLayout lay = scan_layout(m, DV, kScanFwd);
  float* S = smem + lay.off_s;      // (m, DV), z right after it
  float* z = smem + lay.off_z;
  float* psiq = smem + lay.off_q;
  float* psik = smem + lay.off_k;
  float* vs = smem + lay.off_v;
  const int h = blockIdx.x, hk = h / dims.G;
  for (int i = threadIdx.x; i < m * DV + m; i += kThreads) S[i] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    load_rows(qf, h, t0, L, m, psiq, lay.ldp);
    load_rows(kf, hk, t0, L, m, psik, lay.ldp);
    load_rows(v, hk, t0, L, DV, vs, DV);
    __syncthreads();
    tile_scores(psiq, psik, lay.ldp, m, smem + lay.off_sc, lay.ldsc);
    tile_forward<T, DV>(psiq, lay.ldp, vs, S, DV, z, m, smem + lay.off_sc,
                        lay.ldsc, smem + lay.off_den, y, den_out, h, L, t0,
                        dims.delta);
    scan_update<DV>(S, DV, z, psik, lay.ldp, vs, m);
  }
}

// B6a: dΨq of q row h, the forward re-scan.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_q_kernel(const T* __restrict__ kf, const T* __restrict__ v,
                  const T* __restrict__ dy, const T* __restrict__ y,
                  const float* __restrict__ den, T* __restrict__ dq,
                  ScanDims dims) {
  extern __shared__ float smem[];
  const int L = dims.L, m = dims.m;
  const ScanLayout lay = scan_layout(m, DV, kScanBwdQ);
  float* S = smem + lay.off_s;      // (m, lds), z right after it
  float* z = smem + lay.off_z;
  float* psik = smem + lay.off_k;
  float* vs = smem + lay.off_v;
  float* gs = smem + lay.off_g;
  float* hs = smem + lay.off_h;
  float* dp = smem + lay.off_dp;
  const int ldp = lay.ldp, lds = lay.lds;
  const int h = blockIdx.x, hk = h / dims.G;
  for (int i = threadIdx.x; i < m * lds + m; i += kThreads) S[i] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    load_rows(kf, hk, t0, L, m, psik, ldp);
    load_rows(v, hk, t0, L, DV, vs, DV);
    load_cotangents<T, DV>(dy, y, den, h, t0, L, dims.delta, gs, hs);
    __syncthreads();
    tile_dp<DV>(gs, hs, vs, lay.ldsc, dp);
    tile_dpsi_q<DV>(S, lds, z, gs, hs, dp, lay.ldsc, psik, ldp, m,
                    [&](int t, int f, float x) {
                      if (t0 + t < L)
                        dq[((int64_t)h * L + t0 + t) * m + f] = from_f32<T>(x);
                    });
    __syncthreads();
    // Only now: S += Ψkᵀ V, z += Σ Ψk.
    scan_update<DV>(S, lds, z, psik, ldp, vs, m);
  }
}

constexpr int kScanSlice = 128;   // B6b: feature columns per block

// B6b's shared-memory carve-up (floats, each offset 16-byte aligned), then
// the staging bytes, for slices of pw = min(m, 128) columns rounded up to
// a multiple of 16; strides padded by 4 floats as in slay_fused_bwd.cu.
struct KvLayout {
  int pw, ldp, ldc, ldv, ldsc, ldsp, ldsv;
  int off_c, off_z, off_q, off_k, off_v, off_g, off_h, off_sc, off_schi,
      off_dp, off_dv, off_stage;
  int total_bytes;
};

__host__ __device__ inline KvLayout kv_layout(int m, int dv, int es) {
  constexpr int T = kMmaTile;
  KvLayout l;
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
  l.off_g = carve(o, T * l.ldv);
  l.off_h = carve(o, T);
  l.off_sc = carve(o, T * l.ldsc);
  l.off_schi = carve(o, T * l.ldsc);
  l.off_dp = carve(o, T * l.ldsc);
  l.off_dv = carve(o, T * dv);
  l.off_stage = o;
  l.total_bytes = o * 4 + T * (2 * l.ldsp + 3 * l.ldsv) + T * 4;
  return l;
}

// Start copying tile t0's Ψq and Ψk rows of slice columns f0..f0+mc-1,
// v, dy and y rows and den into the staging buffer, in that order; rows
// past L are zero-filled. One commit group. No wait, no sync.
template <typename T, int DV>
__device__ inline void kv_stage(const T* qf, const T* kf, const T* v,
                                const T* dy, const T* y, const float* den,
                                int h, int hk, int t0, int f0, int mc,
                                const ScanDims& dims, const KvLayout& lay,
                                char* stage) {
  constexpr int TT = kMmaTile;
  const int L = dims.L, m = dims.m, es = (int)sizeof(T);
  const int nvalid = L - t0 < TT ? L - t0 : TT;
  const int64_t oq = (int64_t)h * L + t0, ok = (int64_t)hk * L + t0;
  const int64_t sp = (int64_t)m * es, sv = (int64_t)DV * es;
  char* o = stage;
  stage_rows(o, lay.ldsp, reinterpret_cast<const char*>(qf + oq * m + f0),
             sp, mc * es, nvalid);
  o += TT * lay.ldsp;
  stage_rows(o, lay.ldsp, reinterpret_cast<const char*>(kf + ok * m + f0),
             sp, mc * es, nvalid);
  o += TT * lay.ldsp;
  stage_rows(o, lay.ldsv, reinterpret_cast<const char*>(v + ok * DV), sv,
             DV * es, nvalid);
  o += TT * lay.ldsv;
  stage_rows(o, lay.ldsv, reinterpret_cast<const char*>(dy + oq * DV), sv,
             DV * es, nvalid);
  o += TT * lay.ldsv;
  stage_rows(o, lay.ldsv, reinterpret_cast<const char*>(y + oq * DV), sv,
             DV * es, nvalid);
  o += TT * lay.ldsv;
  stage_rows(o, 4, reinterpret_cast<const char*>(den + oq), 4, 4, nvalid);
  cp_async_commit();
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
  const KvLayout lay = kv_layout(m, DV, sizeof(T));
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
    kv_stage<T, DV>(qf, kf, v, dy, y, den, h, hk, (ntiles - 1) * TT, f0, mc,
                    dims, lay, stage);

  for (int tile = ntiles - 1; tile >= 0; --tile) {
    const int t0 = tile * TT;
    cp_async_wait_all();
    __syncthreads();
    const T* sq = reinterpret_cast<const T*>(stage);
    const T* sv = reinterpret_cast<const T*>(stage + 2 * TT * lay.ldsp);
    const int nv = lay.ldsv / (int)sizeof(T);
    unstage_rows(sq, lay.pw, TT, mc, pd, psiq, lay.ldp);
    unstage_rows(sq + TT * lay.pw, lay.pw, TT, mc, pd, psik, lay.ldp);
    unstage_rows(sv, nv, TT, DV, DV, vs, lay.ldv);
    unstage_cotangents<T, DV>(
        sv + TT * nv, sv + 2 * TT * nv,
        reinterpret_cast<const float*>(sv + 3 * TT * nv), dims.delta, gs,
        lay.ldv, hs);
    __syncthreads();
    if (tile > 0)
      kv_stage<T, DV>(qf, kf, v, dy, y, den, h, hk, t0 - TT, f0, mc, dims,
                      lay, stage);
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
  void *out0, *out1;   // y, dq or dk; B6b's dv shares (fp32)
  float* den_out;
};

// Feature slices of B6b: its grid's second axis.
__host__ __device__ inline int kv_slices(int m) {
  return (m + kScanSlice - 1) / kScanSlice;
}

inline long long scan_smem_bytes(int m, int dv, int kind) {
  if (kind == kScanBwdKV) return kv_layout(m, dv, 4).total_bytes;
  return (long long)scan_layout(m, dv, kind).total * 4;
}

template <typename T, int DV>
int launch_scan(int kind, const ScanArgs& a, int bh, const ScanDims& dims,
                cudaStream_t stream) {
  const T* qf = static_cast<const T*>(a.qf);
  const T* kf = static_cast<const T*>(a.kf);
  const T* v = static_cast<const T*>(a.v);
  const T* dy = static_cast<const T*>(a.dy);
  const T* y = static_cast<const T*>(a.y);
  T* out0 = static_cast<T*>(a.out0);
  const size_t smem = kind == kScanBwdKV
                          ? kv_layout(dims.m, DV, sizeof(T)).total_bytes
                          : scan_smem_bytes(dims.m, DV, kind);
  cudaError_t err;
  if (kind == kScanFwd) {
    auto kern = scan_fwd_kernel<T, DV>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<bh, kThreads, smem, stream>>>(qf, kf, v, out0, a.den_out, dims);
  } else if (kind == kScanBwdQ) {
    auto kern = scan_bwd_q_kernel<T, DV>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<bh, kThreads, smem, stream>>>(kf, v, dy, y, a.den, out0, dims);
  } else {
    auto kern = scan_bwd_kv_kernel<T, DV>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(bh, kv_slices(dims.m));   // one block per (row, slice)
    kern<<<grid, kThreads, smem, stream>>>(qf, kf, v, dy, y, a.den, out0,
                                           static_cast<float*>(a.out1), dims);
  }
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

// Residency of B6b's (T, DV) kernel for m feature columns
// (kernel_residency).
template <typename T>
int occupancy_kv(int m, int dv, int* out) {
#define SLAY_SCAN_DV(N)                                                 \
  case N:                                                               \
    return kernel_residency(                                            \
        reinterpret_cast<const void*>(scan_bwd_kv_kernel<T, N>),        \
        kv_layout(m, N, sizeof(T)).total_bytes, out);
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
// B6b (2) needs.
long long slay_scan_smem_bytes(int m, int dv, int kind) {
  return slay::scan_smem_bytes(m, dv, kind);
}

// B5. qf (bh, L, m), kf (bk, L, m), v (bk, L, dv) in fp32 (dtype 0) or
// bf16 (dtype 1). Writes y (bh, L, dv) in the input dtype and den (bh, L)
// fp32. Returns a cudaError_t code (0 = launched).
int slay_scan_fwd(const void* qf, const void* kf, const void* v, void* y,
                  void* den, int bh, int bk, int L, int m, int dv, float delta,
                  int dtype, void* stream) {
  const slay::ScanArgs a{qf, kf, v, nullptr, nullptr, nullptr, y, nullptr,
                         static_cast<float*>(den)};
  return slay::run_scan(slay::kScanFwd, a, bh, bk, L, m, dv, delta,
                        dtype, stream);
}

// B6a. Inputs as B5 plus dy and y (bh, L, dv) in the input dtype and den
// (bh, L) fp32. Writes dq (bh, L, m) in the input dtype.
int slay_scan_bwd_q(const void* qf, const void* kf, const void* v,
                    const void* dy, const void* y, const void* den, void* dq,
                    int bh, int bk, int L, int m, int dv, float delta,
                    int dtype, void* stream) {
  const slay::ScanArgs a{qf, kf, v, dy, y, static_cast<const float*>(den), dq,
                         nullptr, nullptr};
  return slay::run_scan(slay::kScanBwdQ, a, bh, bk, L, m, dv, delta,
                        dtype, stream);
}

// B6b. Inputs as B6a. Writes the per-q-head dk (bh, L, m) in the input
// dtype and each feature slice's share of the per-q-head dv, (C, bh, L,
// dv) fp32 with C = slay_scan_bwd_kv_slices(m); their sum over the slice
// axis is dv. Grid bh x C.
int slay_scan_bwd_kv(const void* qf, const void* kf, const void* v,
                     const void* dy, const void* y, const void* den, void* dk,
                     void* dv_out, int bh, int bk, int L, int m, int dv,
                     float delta, int dtype, void* stream) {
  const slay::ScanArgs a{qf, kf, v, dy, y, static_cast<const float*>(den), dk,
                         dv_out, nullptr};
  return slay::run_scan(slay::kScanBwdKV, a, bh, bk, L, m, dv,
                        delta, dtype, stream);
}

// B6b's feature slices C for m feature columns.
int slay_scan_bwd_kv_slices(int m) { return slay::kv_slices(m); }

// Residency of B6b on the current card for these shapes, as
// slay_fused_bwd_occupancy reports K3's and K4's. Returns a cudaError_t
// code.
int slay_scan_bwd_kv_occupancy(int m, int dv, int dtype, int* out) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return slay::occupancy_kv<float>(m, dv, out);
  if (dtype == 1) return slay::occupancy_kv<__nv_bfloat16>(m, dv, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
