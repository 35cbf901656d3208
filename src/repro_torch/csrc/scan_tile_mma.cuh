// Per-tile phases of the chunked causal scan on the tensor cores, for one
// quadrature node's slice of the state: K3 and K4 (slay_fused_bwd.cu).
//
// Every product of a tile runs as mma.sync.m16n8k8 in TF32 with fp32
// accumulation, in 3xTF32: each fp32 operand is split as a = big + small
// (big = tf32(a), small = tf32(a − big), both rounded to nearest, ties
// away, as cvt.rna) and big·big + big·small + small·big is accumulated,
// which keeps about 21 bits of each operand against single-pass TF32's 10
// (the small·small term is below fp32's rounding of the sum).
//
// A tile is kMmaTile = 16 tokens, one MMA row block. The fp32 operands
// sit in shared memory:
//
//   psiq, psik (16, ldp)   Ψq, Ψk of the tile restricted to one node (pd
//                          = P·D columns)
//   vs, gs     (16, ldv)   v rows; G = dy/(den+δ) rows
//   hs         (16)        h = −Σ(dy∘y)/(den+δ)
//   sc, dp     (16, ldsc)  tril(Ψq Ψkᵀ) of the node (in two halves, sc and
//                          sc_hi); dP = tril(G Vᵀ + h 1ᵀ) (K4; K3 keeps dP
//                          in registers)
//   carry      (pd, ldc)   the node's S or dS; carry_z (pd): z or dz
//
// Each phase is run by the whole block of 8 warps; a warp owns whole
// 16 x 8 output tiles (the two halves of the scores are added in one
// order where they are read), so the result does not depend on
// scheduling. tril keeps the diagonal (causal_keep). As in scan_tile.cuh,
// every reader of the carry runs before the tile is added to it
// (mma_update), so a row never sees its own tile through the state. The
// cp.async helpers at the end stage the next tile's raw rows.
#pragma once

#include <cstdint>

#include "slay_common.cuh"

namespace slay {

constexpr int kMmaTile = 16;   // tokens per tile: the MMA's row count
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 8, "the phases below split work over 8 warps");

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (+ what TF32 drops of the remainder), both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += a·b over one 16 x 8 x 8 step. Fragments (g = lane / 4, q = lane % 4):
// a0 = A(g, q), a1 = A(g+8, q), a2 = A(g, q+4), a3 = A(g+8, q+4);
// b0 = B(q, g), b1 = B(q+4, g); c0, c1 = C(g, 2q), C(g, 2q+1), c2, c3 the
// same in row g+8.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The output tile's (row, column) of fragment element e: rows g, g, g+8,
// g+8 and columns 2q, 2q+1, 2q, 2q+1 (plus 8n for n-tile n).
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int e) {
  return 2 * (threadIdx.x & 3) + (e & 1);
}

template <int NT>
__device__ __forceinline__ void frag_zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// One warp: acc (16 x 8·NT) += A (16 x K) · B (K x 8·NT) in 3xTF32, with
// A(m, k) and B(k, n) read through the given functors. K % 8 == 0. The
// small terms go to accumulators of their own, added at the end, so that
// fewer MMAs wait on each other; the k loop is unrolled so that the next
// steps' operands load while this one's MMAs run.
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_gemm3(float (&acc)[NT][4], int K, FA A,
                                           FB B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float sml[NT][4];
  frag_zero(sml);
#pragma unroll 4
  for (int k = 0; k < K; k += 8) {
    uint32_t ab[4], as[4];
    split_tf32(A(g, k + q), ab[0], as[0]);
    split_tf32(A(g + 8, k + q), ab[1], as[1]);
    split_tf32(A(g, k + q + 4), ab[2], as[2]);
    split_tf32(A(g + 8, k + q + 4), ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(B(k + q, 8 * n + g), bb0, bs0);
      split_tf32(B(k + q + 4, 8 * n + g), bb1, bs1);
      mma_tf32(sml[n], as, bb0, bb1);
      mma_tf32(sml[n], ab, bs0, bs1);
      mma_tf32(acc[n], ab, bb0, bb1);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += sml[n][e];
}

// K4: dp = tril(G Vᵀ + h 1ᵀ) (warps 0-1, one 8-column half each) and the
// node's scores tril(Ψq Ψkᵀ) in two halves over its pd columns: sc (warps
// 2-3) the first, sc_hi (warps 4-5) the second; their sum is the scores.
// No sync.
template <int DV>
__device__ inline void mma_dp_scores(const float* gs, const float* vs,
                                     int ldv, const float* hs,
                                     const float* psiq, const float* psik,
                                     int ldp, int pd, float* dp, float* sc,
                                     float* sc_hi, int ldsc) {
  const int warp = threadIdx.x >> 5;
  float acc[1][4];
  frag_zero(acc);
  if (warp < 2) {
    const int s0 = 8 * warp;
    warp_gemm3<1>(acc, DV, [&](int t, int j) { return gs[t * ldv + j]; },
                  [&](int j, int s) { return vs[(s0 + s) * ldv + j]; });
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = frag_row(e), s = s0 + frag_col(e);
      dp[t * ldsc + s] = causal_keep(t, s) ? acc[0][e] + hs[t] : 0.f;
    }
  } else if (warp < 6) {
    const int s0 = 8 * (warp & 1), f0 = warp < 4 ? 0 : pd / 2;
    float* out = warp < 4 ? sc : sc_hi;
    warp_gemm3<1>(acc, pd / 2,
                  [&](int t, int f) { return psiq[t * ldp + f0 + f]; },
                  [&](int f, int s) { return psik[(s0 + s) * ldp + f0 + f]; });
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = frag_row(e), s = s0 + frag_col(e);
      out[t * ldsc + s] = causal_keep(t, s) ? acc[0][e] : 0.f;
    }
  }
}

// K3: dΨq = G Sᵀ + dP Ψk + h zᵀ for the node's columns, with (S, z) of the
// tiles before this one; written to out (16, ldp), which may be Ψq's own
// buffer (no phase here reads Ψq). Every warp first forms dP = tril(G Vᵀ
// + h 1ᵀ) (16 x 16) in registers: its two 8-column n-tiles, as C
// fragments {c0, c2, c1, c3}, are the A fragments of dP Ψk for s = 0..7
// and 8..15 when the MMA's k index q stands for s = 2q and q + 4 for
// s = 2q + 1, so B reads Ψk's rows in that order. Then warp w: columns
// 16w.. (two n-tiles). No sync.
template <int DV>
__device__ inline void mma_dpsi_q(const float* carry, int ldc,
                                  const float* carry_z, const float* gs,
                                  const float* vs, int ldv, const float* hs,
                                  const float* psik, int ldp, int pd,
                                  float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  float dp[2][4];
  frag_zero(dp);
  warp_gemm3<2>(dp, DV, [&](int t, int j) { return gs[t * ldv + j]; },
                [&](int j, int s) { return vs[s * ldv + j]; });
  uint32_t dpb[2][4], dps[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    constexpr int kOrder[4] = {0, 2, 1, 3};   // C fragment -> A fragment
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = kOrder[e];
      const int t = frag_row(c), s = 8 * n + frag_col(c);
      split_tf32(causal_keep(t, s) ? dp[n][c] + hs[t] : 0.f, dpb[n][e],
                 dps[n][e]);
    }
  }
  for (int f0 = 16 * warp; f0 < pd; f0 += 16 * kWarps) {
    float acc[2][4];
    frag_zero(acc);
    warp_gemm3<2>(acc, DV, [&](int t, int j) { return gs[t * ldv + j]; },
                  [&](int j, int f) { return carry[(f0 + f) * ldc + j]; });
    float sml[2][4];
    frag_zero(sml);
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* col = psik + f0 + 8 * n + g;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(col[(8 * kt + 2 * q) * ldp], bb0, bs0);
        split_tf32(col[(8 * kt + 2 * q + 1) * ldp], bb1, bs1);
        mma_tf32(sml[n], dps[kt], bb0, bb1);
        mma_tf32(sml[n], dpb[kt], bs0, bs1);
        mma_tf32(acc[n], dpb[kt], bb0, bb1);
      }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = frag_row(e), f = f0 + 8 * n + frag_col(e);
        out[t * ldp + f] = (acc[n][e] + sml[n][e]) + hs[t] * carry_z[f];
      }
  }
}

// K4: the node's part of dV = tril(Ψq Ψkᵀ)ᵀ G + Ψk dS, with the scores as
// the two halves sc + sc_hi and dS of the tiles after this one, to out
// (16, DV) fp32. Warp w: columns 8w, 8w + 64, ... No sync.
template <int DV>
__device__ inline void mma_dv(const float* sc, const float* sc_hi, int ldsc,
                              const float* gs, int ldv, const float* psik,
                              int ldp, const float* carry, int ldc, int pd,
                              float* out) {
  const int warp = threadIdx.x >> 5;
  for (int j0 = 8 * warp; j0 < DV; j0 += 8 * kWarps) {
    float acc[1][4];
    frag_zero(acc);
    warp_gemm3<1>(acc, kMmaTile,
                  [&](int s, int t) {
                    return sc[t * ldsc + s] + sc_hi[t * ldsc + s];
                  },
                  [&](int t, int j) { return gs[t * ldv + j0 + j]; });
    warp_gemm3<1>(acc, pd, [&](int s, int f) { return psik[s * ldp + f]; },
                  [&](int f, int j) { return carry[f * ldc + j0 + j]; });
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[frag_row(e) * DV + j0 + frag_col(e)] = acc[0][e];
  }
}

// K4: dΨk = dPᵀ Ψq + V dSᵀ + 1 dzᵀ for the node's columns, with (dS, dz)
// of the tiles after this one, to out (16, ldp), which may be Ψk's own
// buffer once mma_dv has read it. Warp w: columns 16w.. No sync.
template <int DV>
__device__ inline void mma_dpsi_k(const float* carry, int ldc,
                                  const float* carry_z, const float* vs,
                                  int ldv, const float* dp, int ldsc,
                                  const float* psiq, int ldp, int pd,
                                  float* out) {
  const int warp = threadIdx.x >> 5;
  for (int f0 = 16 * warp; f0 < pd; f0 += 16 * kWarps) {
    float acc[2][4];
    frag_zero(acc);
    warp_gemm3<2>(acc, kMmaTile,
                  [&](int s, int t) { return dp[t * ldsc + s]; },
                  [&](int t, int f) { return psiq[t * ldp + f0 + f]; });
    warp_gemm3<2>(acc, DV, [&](int s, int j) { return vs[s * ldv + j]; },
                  [&](int j, int f) { return carry[(f0 + f) * ldc + j]; });
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = frag_row(e), f = f0 + 8 * n + frag_col(e);
        out[s * ldp + f] = acc[n][e] + carry_z[f];
      }
  }
}

// carry (pd, ldc) += Aᵀ B over the tile (A (16, pd) rows of stride ldp, B
// (16, DV) of stride ldv) on the tensor cores, accumulating into the
// carry itself; carry_z += Aᵀ w in fp32, w = nullptr for the ones vector
// (the weight is selected, not the product, as in scan_tile.cuh). S +=
// Ψkᵀ V, z += Σ Ψk, or dS += Ψqᵀ G, dz += Ψqᵀ h. Warp w: feature rows
// 16w.. Ends past a __syncthreads().
template <int DV>
__device__ inline void mma_update(float* carry, int ldc, float* carry_z,
                                  const float* a, int ldp, const float* b,
                                  int ldv, const float* w, int pd) {
  constexpr int NT = DV / 8 < 4 ? DV / 8 : 4;
  const int warp = threadIdx.x >> 5;
  for (int f0 = 16 * warp; f0 < pd; f0 += 16 * kWarps) {
    for (int j0 = 0; j0 < DV; j0 += 8 * NT) {
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] =
              carry[(f0 + frag_row(e)) * ldc + j0 + 8 * n + frag_col(e)];
      warp_gemm3<NT>(acc, kMmaTile,
                     [&](int f, int t) { return a[t * ldp + f0 + f]; },
                     [&](int t, int j) { return b[t * ldv + j0 + j]; });
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          carry[(f0 + frag_row(e)) * ldc + j0 + 8 * n + frag_col(e)] =
              acc[n][e];
    }
  }
  for (int f = threadIdx.x; f < pd; f += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kMmaTile; ++t)
      acc += a[t * ldp + f] * (w == nullptr ? 1.f : w[t]);
    carry_z[f] += acc;
  }
  __syncthreads();
}

// -- asynchronous tile loads -----------------------------------------------

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

// Start copying kMmaTile rows of `rowbytes` bytes (a multiple of 16) from
// src (the tile's first row, 16-byte aligned) to dst; rows at or past
// nvalid are zero-filled. No wait, no sync.
__device__ inline void stage_rows(char* dst, const char* src, int rowbytes,
                                  int nvalid) {
  const int per = rowbytes / 16;
  for (int i = threadIdx.x; i < kMmaTile * per; i += blockDim.x) {
    const int t = i / per;
    const bool ok = t < nvalid;
    cp_async16(dst + i * 16, ok ? src + (int64_t)i * 16 : src, ok);
  }
}

}  // namespace slay
