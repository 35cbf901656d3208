// The per-tile phases of the chunked causal scan on the fp32 pipes, used
// by B5 and B6a (slay_scan.cu), which read Ψ from device memory. K1, K3,
// K4 and B6b left these phases for the tensor-core ones of
// scan_tile_mma.cuh; B5 and B6a are to follow, and this header goes when
// they leave it. These phases are bound by operations run as scalar fp32
// FMAs out of shared memory, about one load per FMA, in one block of 256
// threads per q row. One block walks the sequence in tiles of kTile
// tokens and keeps the fp32 carry (S, z) in shared memory; each function
// below is one phase of one tile, run by the whole block on fp32 tiles in
// shared memory:
//
//   psiq, psik (kTile, ldp)  Ψq, Ψk rows of the tile
//   vs, gs     (kTile, DV)   v rows; G = dy/(den+δ) rows
//   hs         (kTile)       h = −Σ(dy∘y)/(den+δ)
//   sc, dp     (kTile, ldsc) tril(Ψq Ψkᵀ); dP = tril(G Vᵀ + h 1ᵀ)
//   carry      (m, lds)      S; carry_z (m): z
//
// tril keeps the diagonal (causal_keep). Every reader of the carry runs
// before the tile is added to it (scan_update), so a row never sees its
// own tile through the state.
#pragma once

#include <cstdint>

#include "slay_common.cuh"

namespace slay {

constexpr int kTile = 16;      // tokens per tile
constexpr int kRowBlock = 8;   // tile rows one thread carries in the dΨ phases

// sc = tril(Ψq Ψkᵀ). Ends past a __syncthreads().
__device__ inline void tile_scores(const float* psiq, const float* psik,
                                   int ldp, int m, float* sc, int ldsc) {
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int t = i / kTile, s2 = i % kTile;
    float acc = 0.f;
    if (causal_keep(t, s2))
      for (int f = 0; f < m; ++f) acc += psiq[t * ldp + f] * psik[s2 * ldp + f];
    sc[t * ldsc + s2] = acc;
  }
  __syncthreads();
}

// The forward read-out after tile_scores: den = Ψq·z + rowsum(sc) (to
// den_s, one warp per row), then y = (Ψq·S + sc·V)/(den + δ) for q row
// `row`, written with den to rows t0.. of y (rows, L, DV) and den_out
// (rows, L). Thread (column j, rows tg, tg + RG, ...). Ends past a sync.
template <typename T, int DV>
__device__ inline void tile_forward(const float* psiq, int ldp,
                                    const float* vs, const float* S, int lds,
                                    const float* z, int m, const float* sc,
                                    int ldsc, float* den_s, T* y,
                                    float* den_out, int row, int L, int t0,
                                    float delta) {
  constexpr int RG = kThreads / DV;          // row groups
  constexpr int RPT = kTile / RG > 0 ? kTile / RG : 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int t = warp; t < kTile; t += nwarps) {
    float acc = 0.f;
    for (int f = lane; f < m; f += 32) acc += psiq[t * ldp + f] * z[f];
    acc = warp_sum(acc);
    if (lane == 0) {
      float rs = 0.f;
      for (int s2 = 0; s2 < kTile; ++s2) rs += sc[t * ldsc + s2];
      den_s[t] = acc + rs;
    }
  }
  __syncthreads();
  const int j = tid % DV, tg = tid / DV;
  if (tg < kTile) {
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
    for (int f = 0; f < m; ++f) {
      const float sv = S[f * lds + j];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] += psiq[(tg + r * RG) * ldp + f] * sv;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int t = tg + r * RG;
      float intra = 0.f;
      for (int s2 = 0; s2 <= t; ++s2) intra += sc[t * ldsc + s2] * vs[s2 * DV + j];
      if (t0 + t < L) {
        const int64_t o = (int64_t)row * L + t0 + t;
        y[o * DV + j] = from_f32<T>((acc[r] + intra) / (den_s[t] + delta));
        if (j == 0) den_out[o] = den_s[t];
      }
    }
  }
  __syncthreads();
}

// carry += Aᵀ B over the tile (A (kTile, m) in rows of stride ldp, B
// (kTile, DV)) and carry_z += Σ A's rows: S += Ψkᵀ V, z += Σ Ψk. Thread
// (column j, row group tg). Ends past a __syncthreads().
template <int DV>
__device__ inline void scan_update(float* carry, int lds, float* carry_z,
                                   const float* a, int ldp, const float* b,
                                   int m) {
  constexpr int RG = kThreads / DV;
  const int j = threadIdx.x % DV, tg = threadIdx.x / DV;
  float br[kTile];
#pragma unroll
  for (int s2 = 0; s2 < kTile; ++s2) br[s2] = b[s2 * DV + j];
  for (int f = tg; f < m; f += RG) {
    float upd = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kTile; ++s2) upd += a[s2 * ldp + f] * br[s2];
    carry[f * lds + j] += upd;
  }
  for (int f = threadIdx.x; f < m; f += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kTile; ++s2) acc += a[s2 * ldp + f];
    carry_z[f] += acc;
  }
  __syncthreads();
}

// gs = dy/e and hs = −Σ(dy∘y)/e, e = den + δ, of q row h's tile; zero past
// L. No sync.
template <typename T, int DV>
__device__ inline void load_cotangents(const T* dy, const T* y,
                                       const float* den, int h, int t0, int L,
                                       float delta, float* gs, float* hs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < kTile; t += nwarps) {
    const bool in = t0 + t < L;
    const int64_t o = (int64_t)h * L + t0 + t;
    const float e = (in ? den[o] : 0.f) + delta;
    float acc = 0.f;
    for (int j = lane; j < DV; j += 32) {
      const float dyv = in ? to_f32(dy[o * DV + j]) : 0.f;
      const float yv = in ? to_f32(y[o * DV + j]) : 0.f;
      gs[t * DV + j] = dyv / e;
      acc += dyv * yv;
    }
    acc = warp_sum(acc);
    if (lane == 0) hs[t] = -acc / e;
  }
}

// dp = tril(G Vᵀ + h 1ᵀ). Ends past a __syncthreads().
template <int DV>
__device__ inline void tile_dp(const float* gs, const float* hs,
                               const float* vs, int ldsc, float* dp) {
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int t = i / kTile, s2 = i % kTile;
    float acc = 0.f;
    if (causal_keep(t, s2)) {
      for (int j = 0; j < DV; ++j) acc += gs[t * DV + j] * vs[s2 * DV + j];
      acc += hs[t];
    }
    dp[t * ldsc + s2] = acc;
  }
  __syncthreads();
}

// dΨq = G Sᵀ + h zᵀ + dP Ψk with the state of the tiles before this one;
// store(t, f, value) puts each element. Thread item (feature f, block of
// kRowBlock rows). No sync.
template <int DV, typename Store>
__device__ inline void tile_dpsi_q(const float* S, int lds, const float* z,
                                   const float* gs, const float* hs,
                                   const float* dp, int ldsc,
                                   const float* psik, int ldp, int m,
                                   Store store) {
  constexpr int RB = kRowBlock;
  for (int idx = threadIdx.x; idx < m * (kTile / RB); idx += blockDim.x) {
    const int f = idx % m, r0 = (idx / m) * RB;
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    for (int jj = 0; jj < DV; ++jj) {
      const float sv = S[f * lds + jj];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] += gs[(r0 + r) * DV + jj] * sv;
    }
    const float zf = z[f];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int t = r0 + r;
      float intra = 0.f;
      for (int s2 = 0; s2 <= t; ++s2) intra += dp[t * ldsc + s2] * psik[s2 * ldp + f];
      store(t, f, (acc[r] + hs[t] * zf) + intra);
    }
  }
}

}  // namespace slay
