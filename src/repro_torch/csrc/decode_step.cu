// One-token linear-attention decode step for Hopper (sm_90a): K2.
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
// below the card's operations-per-byte balance. At the serving shape there
// are only 48 kv rows, so one block per row leaves most SMs idle and too
// few loads in flight to reach the memory rate. The design therefore
// splits each row's m feature rows into C slices (decode_slices: C <= 8,
// about 48 rows each at m = 384, the last one ragged), one block each,
// launched as one thread-block cluster per kv row (BK x C blocks):
//
//   - a block reads its slice of S as float4, every load of a batch
//     issued before its arithmetic, forms S' = S + Ψkᵀv and z' = z + Ψk
//     with the arithmetic of the one-block design (the product rounded,
//     then added), so S' and z' are unchanged bit for bit, and writes
//     them back in place;
//   - from the registers just written it forms its partial numerators
//     Ψq_g·S'_slice (G x dv) and denominators Ψq_g·z'_slice (G);
//   - after cluster.sync(), rank 0 reads the other blocks' partials
//     through distributed shared memory, adds them in rank order, divides
//     and writes y; a second cluster.sync() keeps every block's shared
//     memory alive until rank 0 has read it.
//
// One launch per layer and decode step, as before, and a fixed order of
// every sum: no atomics. The blocks of an inactive row's cluster all leave
// before either barrier, so no barrier waits on a block that has exited.
//
// Any group size G: a thread keeps the sums of kGroupTile query heads in
// registers, so the G heads go in tiles of kGroupTile. The first tile
// walks the slice as above, updating S and z; each later tile walks it
// again, reading back the S' and z' that the same thread wrote (granite's
// MQA has G = 48: six walks of a slice that stays in L1/L2). Every head's
// sums keep their order, so y is the same bits for any tiling, and S and
// z are still written once, by one block per slice.
#include <cooperative_groups.h>

#include <cstdint>

#include "slay_common.cuh"

namespace slay {

constexpr int kGroupTile = 8;       // query heads a thread sums at once
constexpr int kMaxCluster = 8;      // blocks per kv row (the portable size)
constexpr int kDecodeThreads = 128; // threads per block
constexpr int kMinSliceRows = 16;   // fewest feature rows worth a block
constexpr int kBatch = 8;           // float4 loads a thread issues at once

// Blocks per kv row (the cluster size) and feature rows per block.
struct DecodeSlices {
  int c, rows;
};

inline DecodeSlices decode_slices(int m) {
  int c = (m + kMinSliceRows - 1) / kMinSliceRows;
  c = c < kMaxCluster ? c : kMaxCluster;
  const int rows = (m + c - 1) / c;
  return {(m + rows - 1) / rows, rows};
}

// Dynamic shared memory of one block (floats): Ψq of the slice (G, rows),
// Ψk (rows), one group tile's row-group partial numerators (RG, T, DV)
// and warp partial denominators (warps, T), with T = min(G, kGroupTile),
// and the block's partial num (G, DV) and den (G).
template <int DV>
constexpr size_t decode_smem_floats(int G, int rows) {
  const int T = G < kGroupTile ? G : kGroupTile;
  return (size_t)G * rows + rows +
         (size_t)(kDecodeThreads / (DV / 4)) * T * DV +
         (kDecodeThreads / 32) * T + (size_t)G * DV + G;
}

__device__ __forceinline__ float4 ld4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void st4(float* p, float4 x, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = x;
  } else {
    p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
  }
}

// Block `rank` of kv row blockIdx.x / C: feature rows [rank·rows, +mc).
// vec: s starts on 16 bytes (every row then does, dv being a multiple of
// 4), so S moves as float4; else as four floats.
template <typename TQ, typename TV, int DV>
__global__ void __launch_bounds__(kDecodeThreads)
decode_step_kernel(const TQ* __restrict__ qf, const TQ* __restrict__ kf,
                   const TV* __restrict__ v, float* __restrict__ s,
                   float* __restrict__ z, TV* __restrict__ y,
                   const int32_t* __restrict__ active, int G, int m,
                   int rows, float delta, int vec) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int CG = DV / 4;                 // float4 column groups
  constexpr int RG = kDecodeThreads / CG;    // row groups
  constexpr int kWarps = kDecodeThreads / 32;
  extern __shared__ float smem[];
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  TV* yrow = y + (int64_t)row * G * DV;

  if (active != nullptr && active[row] == 0) {
    // Every block of the cluster leaves here, before any cluster barrier.
    if (rank == 0)
      for (int o = tid; o < G * DV; o += kDecodeThreads)
        yrow[o] = from_f32<TV>(0.f);
    return;
  }
  const int T = G < kGroupTile ? G : kGroupTile;
  float* qs = smem;                  // (G, rows)
  float* ks = qs + G * rows;         // (rows,)
  float* red = ks + rows;            // (RG, T, DV): one tile's partials
  float* wden = red + RG * T * DV;   // (kWarps, T)
  float* pnum = wden + kWarps * T;   // (G, DV): this block's partial num
  float* pden = pnum + G * DV;       // (G,): this block's partial den
  const int i0 = rank * rows;
  const int mc = m - i0 < rows ? m - i0 : rows;
  for (int i = tid; i < G * mc; i += kDecodeThreads) {
    const int g = i / mc, ii = i % mc;
    qs[g * rows + ii] = to_f32(qf[((int64_t)row * G + g) * m + i0 + ii]);
  }
  for (int i = tid; i < mc; i += kDecodeThreads)
    ks[i] = to_f32(kf[(int64_t)row * m + i0 + i]);
  __syncthreads();

  const int cgi = tid % CG, rg = tid / CG;
  const TV* vr = v + (int64_t)row * DV + 4 * cgi;
  const float v0 = to_f32(vr[0]), v1 = to_f32(vr[1]), v2 = to_f32(vr[2]),
              v3 = to_f32(vr[3]);
  float* srow = s + ((int64_t)row * m + i0) * DV + 4 * cgi;
  float* zrow = z + (int64_t)row * m + i0;
  for (int g0 = 0; g0 < G; g0 += kGroupTile) {
    const bool first = g0 == 0;      // this walk updates S and z
    const int gt = G - g0 < kGroupTile ? G - g0 : kGroupTile;
    const float* qt = qs + g0 * rows;
    // S' = S + Ψkᵀv (first walk; later walks read S' back) and
    // Σ_i Ψq[g,i]·S'[i, 4·cgi..4·cgi+3], rows rg, rg + RG, …
    float acc[kGroupTile][4];
#pragma unroll
    for (int g = 0; g < kGroupTile; ++g)
      acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
    for (int b0 = rg; b0 < mc; b0 += RG * kBatch) {
      float4 sv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = b0 + k * RG;
        if (i < mc) sv[k] = ld4(srow + (int64_t)i * DV, vec);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = b0 + k * RG;
        if (i < mc) {
          float4 x = sv[k];
          if (first) {
            const float kv = ks[i];
            x.x = x.x + __fmul_rn(kv, v0);
            x.y = x.y + __fmul_rn(kv, v1);
            x.z = x.z + __fmul_rn(kv, v2);
            x.w = x.w + __fmul_rn(kv, v3);
            st4(srow + (int64_t)i * DV, x, vec);
          }
#pragma unroll
          for (int g = 0; g < kGroupTile; ++g) {
            if (g < gt) {
              const float q = qt[g * rows + i];
              acc[g][0] += q * x.x;
              acc[g][1] += q * x.y;
              acc[g][2] += q * x.z;
              acc[g][3] += q * x.w;
            }
          }
        }
      }
    }
    // z' = z + Ψk (first walk) and the partial denominators Ψq_g·z'.
    float dacc[kGroupTile];
#pragma unroll
    for (int g = 0; g < kGroupTile; ++g) dacc[g] = 0.f;
    for (int i = tid; i < mc; i += kDecodeThreads) {
      float zv = zrow[i];
      if (first) {
        zv = zv + ks[i];
        zrow[i] = zv;
      }
#pragma unroll
      for (int g = 0; g < kGroupTile; ++g)
        if (g < gt) dacc[g] += qt[g * rows + i] * zv;
    }
#pragma unroll
    for (int g = 0; g < kGroupTile; ++g) {
      if (g < gt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(rg * T + g) * DV + 4 * cgi + e] = acc[g][e];
        const float w = warp_sum(dacc[g]);
        if (lane == 0) wden[warp * T + g] = w;
      }
    }
    __syncthreads();
    // The tile's partials, its row groups and warps added in order.
    for (int o = tid; o < gt * DV; o += kDecodeThreads) {
      const int g = o / DV, j = o % DV;
      float num = 0.f;
      for (int r = 0; r < RG; ++r) num += red[(r * T + g) * DV + j];
      pnum[(g0 + g) * DV + j] = num;
    }
    for (int g = tid; g < gt; g += kDecodeThreads) {
      float den = 0.f;
      for (int w = 0; w < kWarps; ++w) den += wden[w * T + g];
      pden[g0 + g] = den;
    }
    __syncthreads();   // red and wden are the next tile's
  }
  cluster.sync();
  if (rank == 0) {
    for (int o = tid; o < G * DV; o += kDecodeThreads) {
      const int g = o / DV;
      float num = 0.f, den = 0.f;
      for (int r = 0; r < C; ++r) {
        num += cluster.map_shared_rank(pnum, r)[o];
        den += cluster.map_shared_rank(pden, r)[g];
      }
      yrow[o] = from_f32<TV>(num / (den + delta));
    }
  }
  cluster.sync();   // the other blocks' shared memory outlives rank 0's reads
}

template <typename TQ, typename TV, int DV>
const void* decode_fn() {
  return reinterpret_cast<const void*>(decode_step_kernel<TQ, TV, DV>);
}

// The kernel for these types and dv, or null.
template <typename TQ, typename TV>
const void* decode_kernel_dv(int dv) {
  switch (dv) {
    case 16: return decode_fn<TQ, TV, 16>();
    case 32: return decode_fn<TQ, TV, 32>();
    case 64: return decode_fn<TQ, TV, 64>();
    case 128: return decode_fn<TQ, TV, 128>();
    default: return nullptr;
  }
}

inline const void* decode_kernel(int q_dtype, int v_dtype, int dv) {
  if (q_dtype == 0 && v_dtype == 0) return decode_kernel_dv<float, float>(dv);
  if (q_dtype == 0 && v_dtype == 1)
    return decode_kernel_dv<float, __nv_bfloat16>(dv);
  if (q_dtype == 1 && v_dtype == 0)
    return decode_kernel_dv<__nv_bfloat16, float>(dv);
  if (q_dtype == 1 && v_dtype == 1)
    return decode_kernel_dv<__nv_bfloat16, __nv_bfloat16>(dv);
  return nullptr;
}

inline size_t decode_smem(int g, int rows, int dv) {
  const size_t f = dv == 16   ? decode_smem_floats<16>(g, rows)
                   : dv == 32 ? decode_smem_floats<32>(g, rows)
                   : dv == 64 ? decode_smem_floats<64>(g, rows)
                              : decode_smem_floats<128>(g, rows);
  return f * sizeof(float);
}

// The launch configuration of `clusters` thread-block clusters of sl.c
// blocks each, built in place (cfg.attrs points into the object).
struct DecodeLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  DecodeLaunch(int clusters, DecodeSlices sl, size_t smem,
               cudaStream_t stream) {
    cfg.gridDim = dim3((unsigned)clusters * sl.c);
    cfg.blockDim = dim3(kDecodeThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)sl.c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  DecodeLaunch(const DecodeLaunch&) = delete;
  DecodeLaunch& operator=(const DecodeLaunch&) = delete;
};

}  // namespace slay

extern "C" {

// qf (bk·g, m), kf (bk, m) in q_dtype; v (bk, dv) in v_dtype (0 fp32,
// 1 bf16); s (bk, m, dv), z (bk, m) fp32, updated in place; y (bk·g, dv)
// in v_dtype; active (bk,) int32 or null. One launch of bk clusters of
// decode_slices(m).c blocks. Returns a cudaError_t code.
int slay_decode_step(const void* qf, const void* kf, const void* v, void* s,
                     void* z, void* y, const void* active, int bk, int g,
                     int m, int dv, int q_dtype, int v_dtype, float delta,
                     void* stream) {
  if (g < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const void* kern = slay::decode_kernel(q_dtype, v_dtype, dv);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  if (bk == 0) return 0;
  const slay::DecodeSlices sl = slay::decode_slices(m);
  const size_t smem = slay::decode_smem(g, sl.rows, dv);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const slay::DecodeLaunch launch(bk, sl, smem,
                                  static_cast<cudaStream_t>(stream));
  int rows = sl.rows, vec = reinterpret_cast<uintptr_t>(s) % 16 == 0;
  void* args[] = {&qf, &kf, &v, &s, &z, &y, &active, &g, &m, &rows,
                  &delta, &vec};
  return (int)cudaLaunchKernelExC(&launch.cfg, kern, args);
}

// How K2 sits on the current device at these shapes: block_residency
// (out[5] the feature rows per block), with out[1] the blocks of the
// clusters resident at once (cudaOccupancyMaxActiveClusters) and out[6]
// the cluster size C.
int slay_decode_step_occupancy(int g, int m, int dv, int q_dtype,
                               int v_dtype, int* out) {
  const void* kern = slay::decode_kernel(q_dtype, v_dtype, dv);
  if (kern == nullptr || g < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  const slay::DecodeSlices sl = slay::decode_slices(m);
  const size_t smem = slay::decode_smem(g, sl.rows, dv);
  int err = slay::block_residency(kern, slay::kDecodeThreads, smem, sl.rows,
                                  out);
  if (err != 0) return err;
  const slay::DecodeLaunch launch(1, sl, smem, nullptr);
  int clusters = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&clusters, kern, &launch.cfg);
  out[1] = clusters * sl.c;
  out[6] = sl.c;
  return err;
}

}  // extern "C"
