// Per-tile phases of the chunked causal scan on the tensor cores, for one
// block's slice of the state: one quadrature node's P·D columns in K1
// (slay_fused.cu), K3 and K4 (slay_fused_bwd.cu), one slice of the
// feature columns in B5, B6a and B6b (slay_scan.cu).
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
//   psiq, psik (16, ldp)   Ψq, Ψk of the tile restricted to the block's
//                          pd columns (a multiple of 16; columns past the
//                          slice are zero)
//   vs, gs     (16, ldv)   v rows; G = dy/(den+δ) rows
//   hs         (16)        h = −Σ(dy∘y)/(den+δ)
//   sc, dp     (16, ldsc)  tril(Ψq Ψkᵀ) of the slice (in two halves, sc
//                          and sc_hi); dP = tril(G Vᵀ + h 1ᵀ) (K4, B6b;
//                          K3 keeps dP in registers)
//   carry      (pd, ldc)   the slice's S or dS; carry_z (pd): z or dz
//
// Each phase is run by the whole block of 8 warps; a warp owns whole
// 16 x 8 output tiles (the two halves of the scores are added in one
// order where they are read), so the result does not depend on
// scheduling. tril keeps the diagonal (causal_keep). Every reader of the
// carry runs before the tile is added to it (mma_update), so a row never
// sees its own tile through the state. The helpers at the end stage the
// next tile's raw rows with cp.async, widen them to fp32, write a block's
// outputs, and sum the forward's shares (fwd_epilogue).
#pragma once

#include <cstdint>

#include "slay_common.cuh"

namespace slay {

constexpr int kMmaTile = 16;   // tokens per tile: the MMA's row count
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 8, "the phases below split work over 8 warps");

// n rounded up to a multiple of 16 (a slice's columns as the MMA phases
// take them).
__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// The offset of the next n floats of a shared-memory carve-up that ends at
// o, which then moves past them, rounded up to 16 bytes.
__host__ __device__ inline int carve(int& o, int n) {
  const int at = o;
  o += (n + 3) / 4 * 4;
  return at;
}

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

// K4, B6b: dp = tril(G Vᵀ + h 1ᵀ) (warps 0-1, one 8-column half each)
// and the slice's scores tril(Ψq Ψkᵀ) in two halves over its pd columns:
// sc (warps 2-3) the first, sc_hi (warps 4-5) the second; their sum is
// the scores. K1 (kDp = false) forms the scores alone and passes no G, V,
// h or dp. No sync.
template <int DV, bool kDp = true>
__device__ inline void mma_dp_scores(const float* gs, const float* vs,
                                     int ldv, const float* hs,
                                     const float* psiq, const float* psik,
                                     int ldp, int pd, float* dp, float* sc,
                                     float* sc_hi, int ldsc) {
  const int warp = threadIdx.x >> 5;
  float acc[1][4];
  frag_zero(acc);
  if (kDp && warp < 2) {
    const int s0 = 8 * warp;
    warp_gemm3<1>(acc, DV, [&](int t, int j) { return gs[t * ldv + j]; },
                  [&](int j, int s) { return vs[(s0 + s) * ldv + j]; });
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = frag_row(e), s = s0 + frag_col(e);
      dp[t * ldsc + s] = causal_keep(t, s) ? acc[0][e] + hs[t] : 0.f;
    }
  } else if (warp >= 2 && warp < 6) {
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

// K4, B6b: the slice's part of dV = tril(Ψq Ψkᵀ)ᵀ G + Ψk dS, with the
// scores as the two halves sc + sc_hi and dS of the tiles after this one,
// to out (16, DV) fp32. Warp w: columns 8w, 8w + 64, ... No sync.
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

// K4, B6b: dΨk = dPᵀ Ψq + V dSᵀ + 1 dzᵀ for the slice's columns, with
// (dS, dz) of the tiles after this one, to out (16, ldp), which may be
// Ψk's own buffer once mma_dv has read it. Warp w: columns 16w.. No sync.
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

// K1: the slice's share of num = Ψq S + tril(Ψq Ψkᵀ) V, with S of the
// tiles before this one and the scores as the two halves sc + sc_hi, and
// of den = Ψq·z + rowsum(scores), for rows t0.. of q row `row`: num to
// (rows, L, DV) and den to (rows, L), fp32, rows past L skipped. num's
// warp w: columns 8w, 8w + 64, ..., stored from the fragments (two
// neighbouring columns a thread); den's warp w: rows w and w + 8, Ψq·z
// on the fp32 pipes. No sync.
template <int DV>
__device__ inline void mma_readout(const float* psiq, int ldp,
                                   const float* carry, int ldc,
                                   const float* carry_z, const float* sc,
                                   const float* sc_hi, int ldsc,
                                   const float* vs, int ldv, int pd,
                                   float* num, float* den, int64_t row,
                                   int t0, int L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j0 = 8 * warp; j0 < DV; j0 += 8 * kWarps) {
    float acc[1][4];
    frag_zero(acc);
    warp_gemm3<1>(acc, pd, [&](int t, int f) { return psiq[t * ldp + f]; },
                  [&](int f, int j) { return carry[f * ldc + j0 + j]; });
    warp_gemm3<1>(acc, kMmaTile,
                  [&](int t, int s) {
                    return sc[t * ldsc + s] + sc_hi[t * ldsc + s];
                  },
                  [&](int s, int j) { return vs[s * ldv + j0 + j]; });
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int t = frag_row(e);
      if (t0 + t < L)
        *reinterpret_cast<float2*>(num + (row * L + t0 + t) * DV + j0 +
                                   frag_col(e)) =
            make_float2(acc[0][e], acc[0][e + 1]);
    }
  }
  for (int t = warp; t < kMmaTile; t += kWarps) {
    float acc = 0.f;
    for (int f = lane; f < pd; f += 32) acc += psiq[t * ldp + f] * carry_z[f];
    acc = warp_sum(acc);
    if (lane == 0 && t0 + t < L) {
      float rs = 0.f;
      for (int s = 0; s < kMmaTile; ++s)
        rs += sc[t * ldsc + s] + sc_hi[t * ldsc + s];
      den[row * L + t0 + t] = acc + rs;
    }
  }
}

// carry (pd, ldc) += Aᵀ B over the tile (A (16, pd) rows of stride ldp, B
// (16, DV) of stride ldv) on the tensor cores, accumulating into the
// carry itself; carry_z += Aᵀ w in fp32, w = nullptr for the ones vector
// (the weight is selected, not the product, so that a·w + acc contracts
// to one FMA whether or not the compiler can see that w is non-null: a·1
// + acc rounds as a + acc). S += Ψkᵀ V, z += Σ Ψk, or dS += Ψqᵀ G, dz +=
// Ψqᵀ h. Warp w: feature rows 16w.. Ends past a __syncthreads().
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

// Start copying kMmaTile rows of `nbytes` bytes, row t from src + t·stride
// bytes, to dst rows of dst_ld bytes (dst and dst_ld 16-byte aligned);
// rows at or past nvalid are zero-filled. 16-byte copies where every
// source row starts on 16 bytes and nbytes is a multiple of 16, 4-byte
// copies where the same holds for 4, else plain 2-byte loads (complete at
// once). kAligned: the caller guarantees the 16-byte case, which is then
// the only code compiled. No commit, no wait, no sync.
template <bool kAligned = false>
__device__ inline void stage_rows(char* dst, int dst_ld, const char* src,
                                  int64_t stride, int nbytes,
                                  int nvalid) {
  const uint64_t align = reinterpret_cast<uint64_t>(src) |
                         static_cast<uint64_t>(stride) |
                         static_cast<uint64_t>(nbytes);
  if (kAligned || align % 16 == 0) {
    const int per = nbytes / 16;
    for (int i = threadIdx.x; i < kMmaTile * per; i += blockDim.x) {
      const int t = i / per, o = (i % per) * 16;
      const bool ok = t < nvalid;
      cp_async16(dst + t * dst_ld + o, ok ? src + t * stride + o : src, ok);
    }
  } else if (align % 4 == 0) {
    const int per = nbytes / 4;
    for (int i = threadIdx.x; i < kMmaTile * per; i += blockDim.x) {
      const int t = i / per, o = (i % per) * 4;
      const bool ok = t < nvalid;
      cp_async4(dst + t * dst_ld + o, ok ? src + t * stride + o : src, ok);
    }
  } else {
    const int per = nbytes / 2;
    for (int i = threadIdx.x; i < kMmaTile * per; i += blockDim.x) {
      const int t = i / per, o = (i % per) * 2;
      *reinterpret_cast<uint16_t*>(dst + t * dst_ld + o) =
          t < nvalid ? *reinterpret_cast<const uint16_t*>(src + t * stride + o)
                     : uint16_t{0};
    }
  }
}

// `rows` staged rows of `ncol` values of type T (row stride src_ld
// values, rows 16-byte aligned) to fp32 rows of stride ld (dst 16-byte
// aligned), with columns ncol..npad-1 set to zero; 16 bytes a thread item
// where the rows allow (no padding, whole chunks), a value a thread item
// otherwise. kAligned: the caller guarantees the first case, which is
// then the only code compiled. No sync.
template <bool kAligned = false, typename T>
__device__ inline void unstage_rows(const T* src, int src_ld, int rows,
                                    int ncol, int npad, float* dst, int ld) {
  constexpr int E = 16 / sizeof(T);   // values per 16-byte chunk
  if (kAligned ||
      (ncol == npad && ncol % E == 0 && src_ld % E == 0 && ld % 4 == 0)) {
    // 16 bytes in, four float4 (bf16) or one (fp32) out per thread item.
    const int per = ncol / E;
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int t = i / per, col = (i % per) * E;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + t * src_ld + col);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(dst + t * ld + col + e) =
            make_float4(to_f32(x[e]), to_f32(x[e + 1]), to_f32(x[e + 2]),
                        to_f32(x[e + 3]));
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * npad; i += blockDim.x) {
    const int t = i / npad, col = i % npad;
    dst[t * ld + col] = col < ncol ? to_f32(src[t * src_ld + col]) : 0.f;
  }
}

// The cotangents of a staged tile: G = dy/e to gs (16, ldv) and h =
// −Σ(dy∘y)/e to hs with e = den + δ, from dy and y rows (DV values each,
// contiguous) and den; one warp per row. Zero rows give zero G and h. No
// sync.
template <typename T, int DV>
__device__ inline void unstage_cotangents(const T* sdy, const T* sy,
                                          const float* sden, float delta,
                                          float* gs, int ldv, float* hs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < kMmaTile; t += nwarps) {
    const float e = sden[t] + delta;
    float acc = 0.f;
    for (int j = lane; j < DV; j += 32) {
      const float dyv = to_f32(sdy[t * DV + j]);
      gs[t * ldv + j] = dyv / e;
      acc += dyv * to_f32(sy[t * DV + j]);
    }
    acc = warp_sum(acc);
    if (lane == 0) hs[t] = -acc / e;
  }
}

// This block's share of tile t0's output rows, (16, ld) fp32 rows in
// shared memory (16-byte aligned), to rows t0.. of part (rows, L, ncol)
// fp32 at row `row`; rows past L are skipped. No sync.
__device__ inline void store_share(const float* share, int ld, int ncol,
                                   float* part, int64_t row, int t0, int L) {
  const int per = ncol / 4;
  for (int i = threadIdx.x; i < kMmaTile * per; i += blockDim.x) {
    const int t = i / per, col = 4 * (i % per);
    if (t0 + t < L)
      *reinterpret_cast<float4*>(part + (row * L + t0 + t) * ncol + col) =
          *reinterpret_cast<const float4*>(share + t * ld + col);
  }
}

// The forward's epilogue, K1's and B5's: y = Σ_c num_c / (Σ_c den_c + δ)
// in T and den = Σ_c den_c, the C shares (quadrature nodes in K1, feature
// slices in B5) summed in the order c = 0, 1, ...; a thread per four
// neighbouring values of y. num (C, n) with n = rows·dv, den_part (C,
// rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_epilogue(const float* __restrict__ num,
             const float* __restrict__ den_part, T* __restrict__ y,
             float* __restrict__ den, int64_t rows, int dv, int C,
             float delta) {
  const int64_t n = rows * dv;
  const int64_t i = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const int64_t row = i / dv;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float e = 0.f;
  for (int c = 0; c < C; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(num + c * n + i);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
    e += den_part[c * rows + row];
  }
  const float inv = e + delta;
  y[i] = from_f32<T>(s.x / inv);
  y[i + 1] = from_f32<T>(s.y / inv);
  y[i + 2] = from_f32<T>(s.z / inv);
  y[i + 3] = from_f32<T>(s.w / inv);
  if (i % dv == 0) den[row] = e;
}

// Launch fwd_epilogue over the rows x dv values of y (dv a multiple of 4).
// Returns a cudaError_t code.
template <typename T>
inline int launch_fwd_epilogue(const float* num, const float* den_part, T* y,
                               float* den, int64_t rows, int dv, int C,
                               float delta, cudaStream_t stream) {
  const int64_t threads = rows * dv / 4;
  fwd_epilogue<T><<<(unsigned)((threads + kThreads - 1) / kThreads),
                    kThreads, 0, stream>>>(num, den_part, y, den, rows, dv, C,
                                           delta);
  return (int)cudaGetLastError();
}

// Residency of kernel fn (kernel_residency's, at kThreads threads and a
// tile of kMmaTile tokens).
inline int kernel_residency(const void* fn, size_t smem, int* out) {
  return block_residency(fn, kThreads, smem, kMmaTile, out);
}

}  // namespace slay
