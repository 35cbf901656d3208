// Causal linear attention on precomputed features for Hopper (sm_90a):
// B5, B6a and B6b, the scan of the two-dispatch path.
//
// Replace the TPU kernels repro/kernels/slay_scan.py::_kernel (B5),
// ::_bwd_q_kernel (B6a) and ::_bwd_kv_kernel (B6b). They are K1, K3 and
// K4 (slay_fused.cu, slay_fused_bwd.cu) with Ψ read from device memory
// (written there by feature_map.cu) instead of computed, and without the
// chain through Ψ. One block per q row h (kv row h / G); the TPU's
// sequential chunk axis becomes a loop over 16-token tiles inside the
// block, with the carry in fp32 shared memory. Ψ tiles arrive in bf16 or
// fp32 and are widened to fp32 in shared memory. With G = dy/(den+δ),
// h = −Σ(dy∘y)/(den+δ) per token and dP = tril(G Vᵀ + h 1ᵀ) per tile:
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
// tril keeps the diagonal. B6b writes per-q-head dk and dv partials; the
// wrapper sums them over each GQA group (no atomics).
//
// What bounds them: operations. Per token and q head each does ≈ 2·m·dv
// for every state term (B5 two, B6a two, B6b four) against ≈ 2 bytes per
// feature column in bf16, so ≈ 100 operations per byte. This first
// version runs them on the fp32 pipes out of shared memory, as K1, K3 and
// K4 do; wgmma, TMA loads and a dv split are later work. Shared memory at
// slayformer shapes (m = 384, dv = 64): B5 154 KB, B6a 135 KB, B6b 161 KB
// of the 227 KB a block may have, checked on the host before launch.
#include <cstdint>

#include "scan_tile.cuh"

namespace slay {

enum ScanKind { kScanFwd = 0, kScanBwdQ = 1, kScanBwdKV = 2 };

struct ScanDims {
  int L, G, m;
  float delta;
};

// Shared-memory carve-up (floats); each kernel takes only what it uses.
// The backward pads the carry's rows (lds = dv + 1) so that threads owning
// neighbouring features read different banks in the dΨ phases.
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
  l.off_q = o;   o += kind == kScanBwdQ ? 0 : T * l.ldp;
  l.off_k = o;   o += T * l.ldp;
  l.off_v = o;   o += T * dv;
  l.off_g = o;   o += bwd ? T * dv : 0;
  l.off_h = o;   o += bwd ? T : 0;
  l.off_sc = o;  o += kind == kScanBwdQ ? 0 : T * l.ldsc;
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
    scan_update<DV>(S, DV, z, psik, lay.ldp, vs, nullptr, m);
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
    tile_dp<DV>(gs, hs, vs, nullptr, nullptr, ldp, m, lay.ldsc, dp, nullptr);
    tile_dpsi_q<DV>(S, lds, z, gs, hs, dp, lay.ldsc, psik, ldp, m,
                    [&](int t, int f, float x) {
                      if (t0 + t < L)
                        dq[((int64_t)h * L + t0 + t) * m + f] = from_f32<T>(x);
                    });
    __syncthreads();
    // Only now: S += Ψkᵀ V, z += Σ Ψk.
    scan_update<DV>(S, lds, z, psik, ldp, vs, nullptr, m);
  }
}

// B6b: per-q-head dΨk and dV of q row h, the reverse scan.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_kv_kernel(const T* __restrict__ qf, const T* __restrict__ kf,
                   const T* __restrict__ v, const T* __restrict__ dy,
                   const T* __restrict__ y, const float* __restrict__ den,
                   T* __restrict__ dk, T* __restrict__ dv_out, ScanDims dims) {
  extern __shared__ float smem[];
  const int L = dims.L, m = dims.m;
  const ScanLayout lay = scan_layout(m, DV, kScanBwdKV);
  float* dS = smem + lay.off_s;     // (m, lds), dz right after it
  float* dz = smem + lay.off_z;
  float* psiq = smem + lay.off_q;
  float* psik = smem + lay.off_k;
  float* vs = smem + lay.off_v;
  float* gs = smem + lay.off_g;
  float* hs = smem + lay.off_h;
  float* sc = smem + lay.off_sc;
  float* dp = smem + lay.off_dp;
  const int ldp = lay.ldp, lds = lay.lds, ldsc = lay.ldsc;
  const int h = blockIdx.x, hk = h / dims.G;
  for (int i = threadIdx.x; i < m * lds + m; i += kThreads) dS[i] = 0.f;

  for (int t0 = (L - 1) / kTile * kTile; t0 >= 0; t0 -= kTile) {
    load_rows(qf, h, t0, L, m, psiq, ldp);
    load_rows(kf, hk, t0, L, m, psik, ldp);
    load_rows(v, hk, t0, L, DV, vs, DV);
    load_cotangents<T, DV>(dy, y, den, h, t0, L, dims.delta, gs, hs);
    __syncthreads();
    tile_dp<DV>(gs, hs, vs, psiq, psik, ldp, m, ldsc, dp, sc);
    // dV and dΨk read the tile and the state and write only device memory.
    tile_dv<T, DV>(psik, ldp, dS, lds, sc, ldsc, gs, m, dv_out, h, L, t0);
    tile_dpsi_k<DV>(dS, lds, dz, vs, dp, ldsc, psiq, ldp, m,
                    [&](int s2, int f, float x) {
                      if (t0 + s2 < L)
                        dk[((int64_t)h * L + t0 + s2) * m + f] = from_f32<T>(x);
                    });
    __syncthreads();
    // Only now: dS += Ψqᵀ G, dz += Ψqᵀ h.
    scan_update<DV>(dS, lds, dz, psiq, ldp, gs, hs, m);
  }
}

struct ScanArgs {
  const void *qf, *kf, *v, *dy, *y;
  const float* den;
  void *out0, *out1;   // y, dq or dk; dv
  float* den_out;
};

template <typename T, int DV>
int launch_scan(int kind, const ScanArgs& a, int bh, const ScanDims& dims,
                size_t smem, cudaStream_t stream) {
  const T* qf = static_cast<const T*>(a.qf);
  const T* kf = static_cast<const T*>(a.kf);
  const T* v = static_cast<const T*>(a.v);
  const T* dy = static_cast<const T*>(a.dy);
  const T* y = static_cast<const T*>(a.y);
  T* out0 = static_cast<T*>(a.out0);
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
    kern<<<bh, kThreads, smem, stream>>>(qf, kf, v, dy, y, a.den, out0,
                                         static_cast<T*>(a.out1), dims);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_scan_dv(int dv, int kind, const ScanArgs& a, int bh,
                     const ScanDims& dims, size_t smem, cudaStream_t stream) {
  switch (dv) {
    case 16: return launch_scan<T, 16>(kind, a, bh, dims, smem, stream);
    case 32: return launch_scan<T, 32>(kind, a, bh, dims, smem, stream);
    case 64: return launch_scan<T, 64>(kind, a, bh, dims, smem, stream);
    case 128: return launch_scan<T, 128>(kind, a, bh, dims, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

inline long long scan_smem_bytes(int m, int dv, int kind) {
  return (long long)scan_layout(m, dv, kind).total * 4;
}

// Checks and dispatch shared by the three C entry points.
inline int run_scan(int kind, const ScanArgs& a, int bh, int bk, int L, int m,
                    int dv, float delta, int dtype, void* stream) {
  if (bk <= 0 || bh % bk || L < 0 || m < 1) return (int)cudaErrorInvalidValue;
  const ScanDims dims{L, bh / bk, m, delta};
  const size_t smem = (size_t)scan_smem_bytes(m, dv, kind);
  auto st = static_cast<cudaStream_t>(stream);
  if (bh == 0 || L == 0) return 0;
  if (dtype == 0) return dispatch_scan_dv<float>(dv, kind, a, bh, dims, smem, st);
  if (dtype == 1)
    return dispatch_scan_dv<__nv_bfloat16>(dv, kind, a, bh, dims, smem, st);
  return (int)cudaErrorInvalidValue;
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
  return slay::run_scan(slay::kScanFwd, a, bh, bk, L, m, dv, delta, dtype,
                        stream);
}

// B6a. Inputs as B5 plus dy and y (bh, L, dv) in the input dtype and den
// (bh, L) fp32. Writes dq (bh, L, m) in the input dtype.
int slay_scan_bwd_q(const void* qf, const void* kf, const void* v,
                    const void* dy, const void* y, const void* den, void* dq,
                    int bh, int bk, int L, int m, int dv, float delta,
                    int dtype, void* stream) {
  const slay::ScanArgs a{qf, kf, v, dy, y, static_cast<const float*>(den), dq,
                         nullptr, nullptr};
  return slay::run_scan(slay::kScanBwdQ, a, bh, bk, L, m, dv, delta, dtype,
                        stream);
}

// B6b. Inputs as B6a. Writes per-q-head dk (bh, L, m) and dv (bh, L, dv)
// partials in the input dtype.
int slay_scan_bwd_kv(const void* qf, const void* kf, const void* v,
                     const void* dy, const void* y, const void* den, void* dk,
                     void* dv_out, int bh, int bk, int L, int m, int dv,
                     float delta, int dtype, void* stream) {
  const slay::ScanArgs a{qf, kf, v, dy, y, static_cast<const float*>(den), dk,
                         dv_out, nullptr};
  return slay::run_scan(slay::kScanBwdKV, a, bh, bk, L, m, dv, delta, dtype,
                        stream);
}

}  // extern "C"
