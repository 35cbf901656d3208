// One-token linear-attention decode step for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/decode_step.py::_kernel (B4a) and
// ::_kernel_masked (B4b); both become this one kernel, the mask being a
// nullable `active` pointer. Per kv row r, with its G query heads:
//
//   S' = S + Ψkᵀ v,   z' = z + Ψk,   y_g = Ψq_g S' / (Ψq_g z' + δ)
//
// S and z are updated in place, as the TPU kernel does through
// input_output_aliases: the caller's cache tensors are the outputs. An
// inactive row (active[r] == 0) writes y = 0 and does not touch S or z at
// all, so its state stays bit-identical.
//
// What bounds it: bytes. Each row reads and writes its m x dv fp32 state
// (2·(m·dv + m)·4 ≈ 200 KB at m = 384, dv = 64) against ≈ 4·m·dv FLOP, far
// below the card's operations-per-byte balance. The design therefore makes
// one pass over S: thread (j, i-group) owns column j of S for a strided
// set of rows, so each warp reads and writes whole 128-byte row segments,
// and the read-out Σ_i Ψq[g,i]·S'[i,j] is accumulated from the registers
// that were just written, never re-read. One block per kv row.
#include <cstdint>

#include "slay_common.cuh"

namespace slay {

constexpr int kMaxGroup = 8;   // query heads per kv head the kernel takes

template <typename TQ, typename TV, int DV>
__global__ void __launch_bounds__(kThreads)
decode_step_kernel(const TQ* __restrict__ qf, const TQ* __restrict__ kf,
                   const TV* __restrict__ v, float* __restrict__ s,
                   float* __restrict__ z, TV* __restrict__ y,
                   const int32_t* __restrict__ active, int G, int m,
                   float delta) {
  extern __shared__ float smem[];
  constexpr int RG = kThreads / DV;            // row groups
  constexpr int kWarps = kThreads / 32;
  float* qs = smem;                            // (G, m)
  float* ks = qs + G * m;                      // (m,)
  float* red = ks + m;                         // (RG, G, DV) partial nums
  float* wden = red + RG * G * DV;             // (kWarps, G) partial dens
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  TV* yrow = y + (int64_t)row * G * DV;

  if (active != nullptr && active[row] == 0) {
    for (int o = tid; o < G * DV; o += kThreads) yrow[o] = from_f32<TV>(0.f);
    return;
  }
  const TQ* qrow = qf + (int64_t)row * G * m;
  for (int i = tid; i < G * m; i += kThreads) qs[i] = to_f32(qrow[i]);
  for (int i = tid; i < m; i += kThreads) ks[i] = to_f32(kf[(int64_t)row * m + i]);
  __syncthreads();

  const int j = tid % DV, ig = tid / DV;
  const float vj = to_f32(v[(int64_t)row * DV + j]);
  float* srow = s + (int64_t)row * m * DV;
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  for (int i = ig; i < m; i += RG) {
    const float sv = srow[i * DV + j] + __fmul_rn(ks[i], vj);
    srow[i * DV + j] = sv;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) acc[g] += qs[g * m + i] * sv;
  }
  // z' = z + Ψk and the denominators Ψq_g·z'.
  float* zrow = z + (int64_t)row * m;
  float dacc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) dacc[g] = 0.f;
  for (int i = tid; i < m; i += kThreads) {
    const float zv = zrow[i] + ks[i];
    zrow[i] = zv;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) dacc[g] += qs[g * m + i] * zv;
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      red[(ig * G + g) * DV + j] = acc[g];
      const float w = warp_sum(dacc[g]);
      if (lane == 0) wden[warp * G + g] = w;
    }
  }
  __syncthreads();
  for (int o = tid; o < G * DV; o += kThreads) {
    const int g = o / DV, jj = o % DV;
    float num = 0.f;
    for (int r = 0; r < RG; ++r) num += red[(r * G + g) * DV + jj];
    float den = 0.f;
    for (int w = 0; w < kWarps; ++w) den += wden[w * G + g];
    yrow[o] = from_f32<TV>(num / (den + delta));
  }
}

template <typename TQ, typename TV, int DV>
int launch_decode(const void* qf, const void* kf, const void* v, float* s,
                  float* z, void* y, const int32_t* active, int bk, int G,
                  int m, float delta, cudaStream_t stream) {
  constexpr int RG = kThreads / DV;
  const size_t smem =
      sizeof(float) * ((size_t)G * m + m + (size_t)RG * G * DV + 8 * G);
  auto kern = decode_step_kernel<TQ, TV, DV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<bk, kThreads, smem, stream>>>(
      static_cast<const TQ*>(qf), static_cast<const TQ*>(kf),
      static_cast<const TV*>(v), s, z, static_cast<TV*>(y), active, G, m,
      delta);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TV>
int dispatch_dv(int dv, const void* qf, const void* kf, const void* v,
                float* s, float* z, void* y, const int32_t* active, int bk,
                int G, int m, float delta, cudaStream_t st) {
  switch (dv) {
    case 16: return launch_decode<TQ, TV, 16>(qf, kf, v, s, z, y, active, bk,
                                              G, m, delta, st);
    case 32: return launch_decode<TQ, TV, 32>(qf, kf, v, s, z, y, active, bk,
                                              G, m, delta, st);
    case 64: return launch_decode<TQ, TV, 64>(qf, kf, v, s, z, y, active, bk,
                                              G, m, delta, st);
    case 128: return launch_decode<TQ, TV, 128>(qf, kf, v, s, z, y, active,
                                                bk, G, m, delta, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ>
int dispatch_v(int v_dtype, int dv, const void* qf, const void* kf,
               const void* v, float* s, float* z, void* y,
               const int32_t* active, int bk, int G, int m, float delta,
               cudaStream_t st) {
  if (v_dtype == 0)
    return dispatch_dv<TQ, float>(dv, qf, kf, v, s, z, y, active, bk, G, m,
                                  delta, st);
  if (v_dtype == 1)
    return dispatch_dv<TQ, __nv_bfloat16>(dv, qf, kf, v, s, z, y, active, bk,
                                          G, m, delta, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace slay

extern "C" {

// qf (bk·g, m), kf (bk, m) in q_dtype; v (bk, dv) in v_dtype (0 fp32,
// 1 bf16); s (bk, m, dv), z (bk, m) fp32, updated in place; y (bk·g, dv)
// in v_dtype; active (bk,) int32 or null. Returns a cudaError_t code.
int slay_decode_step(const void* qf, const void* kf, const void* v, void* s,
                     void* z, void* y, const void* active, int bk, int g,
                     int m, int dv, int q_dtype, int v_dtype, float delta,
                     void* stream) {
  if (g < 1 || g > slay::kMaxGroup || m < 1) return (int)cudaErrorInvalidValue;
  if (bk == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<float*>(s);
  auto zp = static_cast<float*>(z);
  auto ap = static_cast<const int32_t*>(active);
  if (q_dtype == 0)
    return slay::dispatch_v<float>(v_dtype, dv, qf, kf, v, sp, zp, y, ap, bk,
                                   g, m, delta, st);
  if (q_dtype == 1)
    return slay::dispatch_v<__nv_bfloat16>(v_dtype, dv, qf, kf, v, sp, zp, y,
                                           ap, bk, g, m, delta, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
