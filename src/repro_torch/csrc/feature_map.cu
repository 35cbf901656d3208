// The SLAY feature map Ψ(u) and its VJP for Hopper (sm_90a): B7 and B8.
//
// Replace the TPU kernels repro/kernels/feature_map.py::_kernel (B7) and
// ::_bwd_kernel (B8), the first dispatch of the two-dispatch path (the
// feature map writes Ψ to device memory, slay_scan.cu reads it back).
// N, the number of tokens of the flat (N, d) input, need not be a multiple
// of anything, and nothing is padded.
//
// B7: Ψ (N, m) in u's dtype, m = R·P·D. What bounds it: the writes. Per
// token it reads d values and writes m while doing under one fp32
// operation per byte written, so it stays on the fp32 pipes and its
// design serves the write stream:
//
//   - a persistent grid (as many blocks as are resident at once); block b
//     walks tiles b, b + nb, ... of kFwdTile tokens, so the blocks in
//     flight write neighbouring ranges of Ψ; the projections [A; Ω] and a
//     table of Ψ's 16-byte chunks are loaded once per block;
//   - the next tile's rows of u arrive by 16-byte cp.async into a ring of
//     two while the current tile computes;
//   - each value is computed as psi_rows of slay_common.cuh computes it
//     (the Ψ that K1, K3 and K4 build inside their scans), every fp32
//     operation in the same order, so Ψ is the same bit for bit: û by one
//     warp per row, each projection a sequential sum with a lane per token,
//     φ as psi_projection_out, Ψ = (φ_p·φ_e)·√w_r;
//   - a tile's Ψ rows are one contiguous range of the output: thread i
//     writes its 16-byte chunks i, i + kThreads, ... of that range straight
//     from registers as streaming stores (st.global.cs), neighbouring lanes
//     on neighbouring addresses, with no integer division (the chunk's
//     node, anchor and columns come from the table). No Ψ tile is staged
//     in shared memory: staging it and storing it by cp.async.bulk was
//     1.25x slower on an H100 (PERF.md §6). Shapes whose chunks straddle two
//     anchors, or a Ψ not on 16 bytes, take a plain path of scalar stores.
//
// B8: the VJP, du (N, d) and dA (P, d), dΩ (D, d). What bounds it: bytes.
// Per token it reads d + m values and writes d while doing about 13
// operations per byte (chip_smoke.py::_psi_ops), below the card's fp32
// balance (67 TFLOP/s over 3.35 TB/s, 20 per byte), so it stays on the
// fp32 pipes: tensor cores would buy nothing. The design follows from
// that, and from the VJP's needing only û, inv, pa (P), φ_p (P) and φ_e
// (R·D) of each token, never the Kronecker Ψ:
//
//   - a persistent grid (slay_feature_map_bwd_blocks) of 8-warp blocks;
//     global warp w walks tokens w, w + W, ... (W warps in all), so the
//     warps in flight read neighbouring rows;
//   - one warp per token, two tokens at a time (kRW), so that every phase
//     carries two independent chains: each warp streams its next pair of
//     rows of u and dΨ into its own ring of shared memory with cp.async
//     (16 bytes a lane, neighbouring lanes on neighbouring addresses, dΨ
//     in its own dtype) while it computes the current pair, and
//     synchronises with __syncwarp alone;
//   - lane l owns kQ neighbouring columns of û: the projections ûᵀ[A; Ω]
//     are lane partials summed by a reduce-scatter over the warp
//     (reduce_projections: 31 shuffles leave lane c with projection c),
//     lane c then forms φ_p or φ_e, the dpa and dpw sums run as items
//     spread over the lanes, and dû = dpa·A + dpw·Ω, du = inv·(dû −
//     û (ûᵀdû)) run on the lane's columns again;
//   - each lane keeps its columns of the dA/dΩ sums in registers across
//     the tokens its warp walks (in per-warp shared memory where P + D or
//     d is too large for registers); at the end the block adds its warps'
//     sums in warp order and writes one dA/dΩ partial, which the wrapper
//     sums: no atomics.
#include <cstdint>

#include "slay_common.cuh"

namespace slay {

constexpr int kFwdTile = 32;   // tokens per tile: one a lane
constexpr int kFwdCols = 3;    // projection columns a lane carries at once
constexpr int kFwdWarps = kThreads / 32;

__host__ __device__ inline int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// One 16-byte chunk of a Ψ row (16 / sizeof(T) neighbouring columns of one
// node and anchor): φ_p's index, the first φ_e index, √w_r.
struct FwdChunk {
  int p, e;
  float sw;
  int pad;   // an entry is 16 bytes
};

// B7's shared-memory carve-up in bytes: the ring of two tiles of raw u rows
// (in u's dtype), û (kFwdTile rows of ldu floats), the projections A then
// Ω (P + D rows of ldu floats), φ (kFwdTile rows of ldphi floats: φ_p, then
// from pe on φ_e of every node), the chunk table. ldu is 4 times an odd
// number (float4 rows, a lane per row without bank conflicts); pe and
// ldphi are multiples of 4 (float4 loads of φ_e).
struct FwdLayout {
  int ldu, pe, ldphi, chunks;
  int tile_bytes, uh, aw, phi, table;
  int total;
};

__host__ __device__ inline FwdLayout fwd_layout(int d, int P, int D, int R,
                                                int es) {
  FwdLayout l;
  l.ldu = (d + 3) & ~3;
  if ((l.ldu / 4) % 2 == 0) l.ldu += 4;
  l.pe = (P + 3) & ~3;
  l.ldphi = (l.pe + R * D + 3) & ~3;
  l.chunks = R * P * D * es / 16;
  l.tile_bytes = round16(kFwdTile * d * es);
  int o = 2 * l.tile_bytes;
  l.uh = o;     o += kFwdTile * l.ldu * 4;
  l.aw = o;     o += (P + D) * l.ldu * 4;
  l.phi = o;    o += kFwdTile * l.ldphi * 4;
  l.table = o;  o += l.chunks * (int)sizeof(FwdChunk);
  l.total = o;
  return l;
}

// v[r] for a node index known only at run time, without indexing the
// kernel's parameter space (which would copy PsiConsts to local memory).
__device__ __forceinline__ float node_const(const float (&v)[kMaxNodes],
                                            int r) {
  float x = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxNodes; ++k)
    if (k == r) x = v[k];
  return x;
}

// One 16-byte chunk of Ψ in T (16 / sizeof(T) columns) from φ_p, the
// chunk's φ_e and √w_r.
template <typename T>
__device__ __forceinline__ uint4 psi_chunk(float php, const float* phe,
                                           float sw);

template <>
__device__ __forceinline__ uint4 psi_chunk<float>(float php, const float* phe,
                                                  float sw) {
  const float4 e = *reinterpret_cast<const float4*>(phe);
  return make_uint4(__float_as_uint((php * e.x) * sw),
                    __float_as_uint((php * e.y) * sw),
                    __float_as_uint((php * e.z) * sw),
                    __float_as_uint((php * e.w) * sw));
}

// Two values rounded to bf16 as from_f32 rounds them, a in the low half.
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <>
__device__ __forceinline__ uint4 psi_chunk<__nv_bfloat16>(float php,
                                                          const float* phe,
                                                          float sw) {
  const float4 e0 = *reinterpret_cast<const float4*>(phe);
  const float4 e1 = *reinterpret_cast<const float4*>(phe + 4);
  return make_uint4(bf16_pair((php * e0.x) * sw, (php * e0.y) * sw),
                    bf16_pair((php * e0.z) * sw, (php * e0.w) * sw),
                    bf16_pair((php * e1.x) * sw, (php * e1.y) * sw),
                    bf16_pair((php * e1.z) * sw, (php * e1.w) * sw));
}

// B7: Ψ of the tiles b, b + nb, ... (nb blocks in all) of this block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
feature_map_fwd_kernel(const T* __restrict__ u,
                       const float* __restrict__ anchors,
                       const float* __restrict__ omegas, T* __restrict__ psi,
                       int n, int d, PsiConsts c) {
  extern __shared__ __align__(16) char smem_f[];
  constexpr int es = (int)sizeof(T);
  const int P = c.P, D = c.D, R = c.R, npd = P + D, pd = P * D, m = R * pd;
  const FwdLayout lay = fwd_layout(d, P, D, R, es);
  const int ldu = lay.ldu, ldphi = lay.ldphi, chunks = lay.chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* uh = reinterpret_cast<float*>(smem_f + lay.uh);
  float* aw = reinterpret_cast<float*>(smem_f + lay.aw);
  float* phi = reinterpret_cast<float*>(smem_f + lay.phi);
  FwdChunk* table = reinterpret_cast<FwdChunk*>(smem_f + lay.table);

  const bool vec_u =
      (reinterpret_cast<uintptr_t>(u) | (uintptr_t)(d * es)) % 16 == 0;
  const bool vec_psi =
      (reinterpret_cast<uintptr_t>(psi) | (uintptr_t)(D * es)) % 16 == 0;
  for (int i = tid; i < npd * d; i += kThreads) {
    const int row = i / d, col = i % d;
    aw[row * ldu + col] =
        row < P ? anchors[row * d + col] : omegas[(row - P) * d + col];
  }
  if (vec_psi) {
    for (int q = tid; q < chunks; q += kThreads) {
      const int col = q * (16 / es), r = col / pd;
      table[q] = {(col % pd) / D, lay.pe + r * D + col % D,
                  node_const(c.sqrt_w, r), 0};
    }
  }

  // The rows of tile `tile` into ring slot `slot` (16-byte cp.async; the
  // tile's rows are one contiguous range of u).
  const int tiles = (n + kFwdTile - 1) / kFwdTile;
  auto stage = [&](int tile, int slot) {
    const int t0 = tile * kFwdTile;
    const int bytes = min(kFwdTile, n - t0) * d * es;
    const char* src = reinterpret_cast<const char*>(u + (int64_t)t0 * d);
    char* dst = smem_f + slot * lay.tile_bytes;
    for (int o = tid * 16; o < bytes; o += kThreads * 16)
      cp_async16(dst + o, src + o, true);
  };
  if (vec_u && blockIdx.x < tiles) stage(blockIdx.x, 0);
  cp_async_commit();
  // This thread's first chunk of a tile and the step to its next, as
  // (token, chunk of the row) pairs.
  const int t_first = tid / max(chunks, 1), q_first = tid % max(chunks, 1);
  const int t_step = kThreads / max(chunks, 1);
  const int q_step = kThreads % max(chunks, 1);
  int slot = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (vec_u && next < tiles) stage(next, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // the tile's rows, and on the first pass aw, table
    const int t0 = tile * kFwdTile, rows = min(kFwdTile, n - t0);
    const T* ut = vec_u ? reinterpret_cast<const T*>(smem_f +
                                                     slot * lay.tile_bytes)
                        : u + (int64_t)t0 * d;

    // normalize: one warp per row, rsqrt of the fp32 square sum (lane l
    // adds columns l, l + 32, ..., then warp_sum), as psi_rows.
    for (int t = warp; t < rows; t += kFwdWarps) {
      const T* ur = ut + t * d;
      float acc = 0.f;
      for (int i = lane; i < d; i += 32) {
        const float x = to_f32(ur[i]);
        acc += x * x;
      }
      const float inv = rsqrtf(warp_sum(acc) + 1e-6f);
      for (int i = lane; i < d; i += 32) uh[t * ldu + i] = to_f32(ur[i]) * inv;
    }
    __syncthreads();

    // Projections: lane t keeps token t against columns warp, warp + 8,
    // ...; each a sequential sum over i, then φ_p, or φ_e of every node.
    {
      const float* ur = uh + lane * ldu;
      for (int col0 = warp; col0 < npd; col0 += kFwdWarps * kFwdCols) {
        float dot[kFwdCols];
#pragma unroll
        for (int k = 0; k < kFwdCols; ++k) dot[k] = 0.f;
        int i = 0;
        // Unrolled 4 times and the chunk loop below not at all: the
        // unrolling that keeps ptxas (CUDA 12.8) from spilling.
#pragma unroll 4
        for (; i + 4 <= d; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(ur + i);
#pragma unroll
          for (int k = 0; k < kFwdCols; ++k) {
            const int col = col0 + k * kFwdWarps;
            if (col < npd) {
              const float4 a =
                  *reinterpret_cast<const float4*>(aw + col * ldu + i);
              dot[k] += x.x * a.x;
              dot[k] += x.y * a.y;
              dot[k] += x.z * a.z;
              dot[k] += x.w * a.w;
            }
          }
        }
        for (; i < d; ++i) {
#pragma unroll
          for (int k = 0; k < kFwdCols; ++k) {
            const int col = col0 + k * kFwdWarps;
            if (col < npd) dot[k] += ur[i] * aw[col * ldu + i];
          }
        }
        if (lane < rows) {
          float* ph = phi + lane * ldphi;
#pragma unroll
          for (int k = 0; k < kFwdCols; ++k) {
            const int col = col0 + k * kFwdWarps;
            if (col < P) {
              ph[col] = (dot[k] * dot[k]) * c.inv_sqrt_p;
            } else if (col < npd) {
#pragma unroll
              for (int r = 0; r < kMaxNodes; ++r)
                if (r < R)
                  ph[lay.pe + r * D + col - P] =
                      expf(__fmul_rn(c.sqrt2s[r], dot[k]) - c.s[r]) *
                      c.inv_sqrt_d;
            }
          }
        }
      }
    }
    __syncthreads();

    // Ψ = (φ_p ⊗ φ_e)·√w_r: the tile's rows, one contiguous range.
    if (vec_psi) {
      uint4* dst = reinterpret_cast<uint4*>(psi + (int64_t)t0 * m);
      int t = t_first, q = q_first;
#pragma unroll 1
      for (int it = tid; it < rows * chunks; it += kThreads) {
        const FwdChunk ch = table[q];
        const float* ph = phi + t * ldphi;
        __stcs(dst + it, psi_chunk<T>(ph[ch.p], ph + ch.e, ch.sw));
        t += t_step;
        q += q_step;
        if (q >= chunks) {
          q -= chunks;
          ++t;
        }
      }
    } else {
      for (int i = tid; i < rows * m; i += kThreads) {
        const int t = i / m, col = i % m;
        const int r = col / pd, p = (col % pd) / D, j = col % D;
        psi[((int64_t)t0 + t) * m + col] = from_f32<T>(
            (phi[t * ldphi + p] * phi[t * ldphi + lay.pe + r * D + j]) *
            node_const(c.sqrt_w, r));
      }
    }
    slot ^= 1;
  }
  cp_async_wait_all();
}


// -- B8 -------------------------------------------------------------------

constexpr int kBwdWarps = kThreads / 32;   // warps per block
constexpr int kRW = 2;          // tokens a warp carries at once
constexpr int kBwdStages = 2;   // token pairs per warp in shared memory:
                                // the current one and the next in flight
constexpr int kRegRows = 24;    // dA/dΩ rows (P + D) a lane keeps in
                                // registers; more go to shared memory

// S, the parts each dpa sum (D terms per node) is split into so that the
// P·S dpa items and the D dpw items (P terms per node) fill one warp: the
// largest S dividing D with P·S + D <= 32, at least 1.
__host__ __device__ inline int bwd_split(int P, int D) {
  int best = 1;
  for (int s = 2; s <= D; ++s)
    if (D % s == 0 && P * s + D <= 32) best = s;
  return best;
}

// B8's shared-memory carve-up in bytes: the projections A then Ω (P + D
// rows of ldw = 32·kq floats, zero past d), the block's dA/dΩ sums (P + D
// rows of d floats), then one region per warp: its ring of kBwdStages x
// kRW staged rows (u, then dΨ, each in the input dtype and padded to 16
// bytes), and per token it carries φ_p (P), φ_e (R·D), pa (P) and inv,
// the dpa/dpw items and dproj (P + D); without register sums also its
// dA/dΩ sums (P + D rows of ldw).
struct BwdLayout {
  int kq, ldw, split, reg_acc;
  int u_bytes, row_bytes;
  int aw, daw, warps, per_warp;
  int w_phi, w_item, w_dproj, w_acc;   // per-token scratch: kRW of each
  int phi_ld, item_ld, dproj_ld;       // floats between two tokens' copies
  int total;
};

__host__ __device__ inline BwdLayout bwd_layout(int d, int P, int D, int R,
                                                int es) {
  BwdLayout l;
  const int npd = P + D;
  l.kq = d <= 32 ? 1 : d <= 64 ? 2 : 4;
  l.ldw = 32 * l.kq;
  l.split = bwd_split(P, D);
  l.reg_acc = npd <= kRegRows && l.kq <= 2;
  l.u_bytes = round16(d * es);
  l.row_bytes = l.u_bytes + round16(R * P * D * es);
  l.phi_ld = round16((2 * P + R * D + 1) * 4) / 4;
  l.item_ld = round16((P * l.split + D) * 4) / 4;
  l.dproj_ld = round16(npd * 4) / 4;
  int o = 0;
  l.aw = o;    o += round16(npd * l.ldw * 4);
  l.daw = o;   o += round16(npd * d * 4);
  l.warps = o;
  int w = kBwdStages * kRW * l.row_bytes;
  l.w_phi = w;   w += kRW * l.phi_ld * 4;
  l.w_item = w;  w += kRW * l.item_ld * 4;
  l.w_dproj = w; w += kRW * l.dproj_ld * 4;
  l.w_acc = w;   w += l.reg_acc ? 0 : npd * l.ldw * 4;
  l.per_warp = round16(w);
  l.total = o + kBwdWarps * l.per_warp;
  return l;
}

// x[0..kQ) = p[0..kQ), one shared-memory load (p aligned to 4·kQ bytes).
template <int kQ>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[kQ]) {
  if constexpr (kQ == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (kQ == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

// warp_sum of each x[e], the kRW butterflies interleaved.
__device__ __forceinline__ void warp_sums(float (&x)[kRW]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int e = 0; e < kRW; ++e)
      x[e] += __shfl_xor_sync(0xffffffffu, x[e], off);
}

// One step of the warp's reduce-scatter (reduce_projections): each lane
// keeps the half of its H slots that its lane bit H selects and adds the
// partner's copy of that half; then the next step, down to one slot.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[kRW][16],
                                                    int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int e = 0; e < kRW; ++e) {
      const float send = up ? v[e][k] : v[e][k + H];
      const float keep = up ? v[e][k + H] : v[e][k];
      v[e][k] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
  }
  if constexpr (H > 1) reduce_scatter_step<H / 2>(v, lane);
}

// dot[e] of lane l: the warp's sum over lanes of ûᵀaw_{base + l} for
// token e (zero past npd), from each lane's partial over its kQ columns.
// The partials of rows k and k + 16 are formed together and halved at
// once, so a lane carries 16 slots a token; four more halvings leave lane
// l with row base + l: 31 shuffles a token. Each projection row is loaded
// once for the kRW tokens.
template <int kQ>
__device__ __forceinline__ void reduce_projections(
    const float* aw, int ldw, int base, int npd, const float (&uh)[kRW][kQ],
    int lane, float (&dot)[kRW]) {
  const bool up = lane & 16;
  float v[kRW][16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float p[kRW][2] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (base + k + 16 * h < npd) {
        float a[kQ];
        load_cols<kQ>(aw + (base + k + 16 * h) * ldw + lane * kQ, a);
#pragma unroll
        for (int e = 0; e < kRW; ++e)
#pragma unroll
          for (int q = 0; q < kQ; ++q) p[e][h] += uh[e][q] * a[q];
      }
    }
#pragma unroll
    for (int e = 0; e < kRW; ++e)
      v[e][k] = (up ? p[e][1] : p[e][0]) +
                __shfl_xor_sync(0xffffffffu, up ? p[e][0] : p[e][1], 16);
  }
  reduce_scatter_step<8>(v, lane);
#pragma unroll
  for (int e = 0; e < kRW; ++e) dot[e] = v[e][0];
}

// B8: du of every token this block's warps walk, and the block's dA, dΩ
// sums. kQ columns of û per lane (d <= 32·kQ); kRegAcc: the dA/dΩ sums in
// registers (P + D <= kRegRows), else in the warp's shared memory. Global
// warp w walks tokens w, w + W, w + 2W, ... (W warps in all), kRW of them
// at once, and adds each token to its sums in that order.
template <typename T, int kQ, bool kRegAcc>
__global__ void __launch_bounds__(kThreads, 2)
feature_map_bwd_kernel(const T* __restrict__ u,
                       const float* __restrict__ anchors,
                       const float* __restrict__ omegas,
                       const T* __restrict__ dpsi, T* __restrict__ du,
                       float* __restrict__ da_out, float* __restrict__ dw_out,
                       int n, int d, PsiConsts c) {
  extern __shared__ __align__(16) char smem_b[];
  const int P = c.P, D = c.D, R = c.R, npd = P + D, pd = P * D, m = R * pd;
  const BwdLayout lay = bwd_layout(d, P, D, R, (int)sizeof(T));
  const int ldw = lay.ldw, S = lay.split, K = D / S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* aw = reinterpret_cast<float*>(smem_b + lay.aw);
  float* daw = reinterpret_cast<float*>(smem_b + lay.daw);
  char* wreg = smem_b + lay.warps + warp * lay.per_warp;
  float* phi0 = reinterpret_cast<float*>(wreg + lay.w_phi);
  float* item0 = reinterpret_cast<float*>(wreg + lay.w_item);
  float* dproj0 = reinterpret_cast<float*>(wreg + lay.w_dproj);
  float* acc_s = reinterpret_cast<float*>(wreg + lay.w_acc);

  for (int i = threadIdx.x; i < npd * ldw; i += blockDim.x) {
    const int row = i / ldw, col = i % ldw;
    aw[i] = col >= d      ? 0.f
            : row < P     ? anchors[row * d + col]
                          : omegas[(row - P) * d + col];
  }
  float acc[kRegAcc ? kRegRows : 1][kQ];
#pragma unroll
  for (int col = 0; col < (kRegAcc ? kRegRows : 1); ++col)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[col][q] = 0.f;
  if constexpr (!kRegAcc)
    for (int i = lane; i < npd * ldw; i += 32) acc_s[i] = 0.f;
  __syncthreads();

  // Rows t0 + e·nw (e < kRW, those before n) of u and of dΨ into ring slot
  // `slot`: 16-byte cp.async where every row starts on 16 bytes, else
  // plain copies (complete at once).
  const int nw = gridDim.x * kBwdWarps;
  const int ub = d * (int)sizeof(T), pb = m * (int)sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(u) |
                     reinterpret_cast<uintptr_t>(dpsi) | ub | pb) % 16) == 0;
  auto stage = [&](int t0, int slot) {
#pragma unroll
    for (int e = 0; e < kRW; ++e) {
      const int t = t0 + e * nw;
      if (t >= n) break;
      char* dst = wreg + (slot * kRW + e) * lay.row_bytes;
      if (vec) {
        const char* su = reinterpret_cast<const char*>(u + (int64_t)t * d);
        const char* sp =
            reinterpret_cast<const char*>(dpsi + (int64_t)t * m);
        for (int o = lane * 16; o < ub; o += 32 * 16)
          cp_async16(dst + o, su + o, true);
        for (int o = lane * 16; o < pb; o += 32 * 16)
          cp_async16(dst + lay.u_bytes + o, sp + o, true);
      } else {
        T* su = reinterpret_cast<T*>(dst);
        T* sp = reinterpret_cast<T*>(dst + lay.u_bytes);
        for (int i = lane; i < d; i += 32) su[i] = u[(int64_t)t * d + i];
        for (int i = lane; i < m; i += 32) sp[i] = dpsi[(int64_t)t * m + i];
      }
    }
  };

  const int t_first = blockIdx.x * kBwdWarps + warp;
  const int step = kRW * nw;
  int t_next = t_first;
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (t_next < n) stage(t_next, s);
    cp_async_commit();
    t_next += step;
  }
  int slot = 0;
  for (int t0 = t_first; t0 < n; t0 += step) {
    if (t_next < n) stage(t_next, (slot + kBwdStages - 1) % kBwdStages);
    cp_async_commit();
    t_next += step;
    cp_async_wait<kBwdStages - 1>();
    __syncwarp();
    bool valid[kRW];
    const T* ur[kRW];
    const T* dr[kRW];
#pragma unroll
    for (int e = 0; e < kRW; ++e) {
      valid[e] = t0 + e * nw < n;
      ur[e] = reinterpret_cast<const T*>(wreg +
                                         (slot * kRW + e) * lay.row_bytes);
      dr[e] = reinterpret_cast<const T*>(
          reinterpret_cast<const char*>(ur[e]) + lay.u_bytes);
    }

    // û on the lane's columns (zero for a token past n); inv = rsqrt(‖u‖²
    // + ε).
    float uh[kRW][kQ], inv[kRW];
#pragma unroll
    for (int e = 0; e < kRW; ++e) {
      inv[e] = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int col = lane * kQ + q;
        uh[e][q] = valid[e] && col < d ? to_f32(ur[e][col]) : 0.f;
        inv[e] += uh[e][q] * uh[e][q];
      }
    }
    warp_sums(inv);
#pragma unroll
    for (int e = 0; e < kRW; ++e) {
      inv[e] = rsqrtf(inv[e] + 1e-6f);
#pragma unroll
      for (int q = 0; q < kQ; ++q) uh[e][q] *= inv[e];
      // Kept in shared memory until du, a register fewer through the
      // projections and sums.
      if (lane == 0) phi0[e * lay.phi_ld + 2 * P + R * D] = inv[e];
    }

    // Projections ûᵀa_col, 32 columns a round: lane col keeps column
    // col's and forms pa and φ_p, or φ_e of every node.
    for (int base = 0; base < npd; base += 32) {
      float dot[kRW];
      reduce_projections<kQ>(aw, ldw, base, npd, uh, lane, dot);
      const int col = base + lane;
#pragma unroll
      for (int e = 0; e < kRW; ++e) {
        float* phi = phi0 + e * lay.phi_ld;
        if (col < P) {
          phi[P + R * D + col] = dot[e];   // pa
          phi[col] = (dot[e] * dot[e]) * c.inv_sqrt_p;
        } else if (col < npd) {
          const int j = col - P;
#pragma unroll
          for (int r = 0; r < kMaxNodes; ++r)
            if (r < R)
              phi[P + r * D + j] =
                  expf(__fmul_rn(c.sqrt2s[r], dot[e]) - c.s[r]) *
                  c.inv_sqrt_d;
        }
      }
    }
    __syncwarp();

    // The dpa and dpw sums as items over the lanes, node by node as
    // psi_dproj: item (p, h) < P·S sums the h-th K = D/S terms of dφ_p[p],
    // item P·S + j the P terms of node r's de[j], weighted by √(2s_r)φ_e.
    for (int it = lane; it < P * S + D; it += 32) {
      const bool is_pa = it < P * S;
      const int j = is_pa ? 0 : it - P * S;
      const int db = is_pa ? (it / S) * D + (it % S) * K : j;
      const int ds = is_pa ? 1 : D;
      const int nk = is_pa ? K : P;
      const int fb = is_pa ? P + (it % S) * K : 0;
      const int fr = is_pa ? D : 0;
      float a[kRW] = {};
#pragma unroll
      for (int r = 0; r < kMaxNodes; ++r) {
        if (r < R) {
          const float sw = c.sqrt_w[r];
          float sr[kRW] = {};
#pragma unroll 4
          for (int k = 0; k < nk; ++k) {
#pragma unroll
            for (int e = 0; e < kRW; ++e)
              sr[e] += (to_f32(dr[e][r * pd + db + k * ds]) * sw) *
                       phi0[e * lay.phi_ld + fb + r * fr + k];
          }
#pragma unroll
          for (int e = 0; e < kRW; ++e)
            a[e] += (is_pa ? 1.f
                           : c.sqrt2s[r] *
                                 phi0[e * lay.phi_ld + P + r * D + j]) *
                    sr[e];
        }
      }
#pragma unroll
      for (int e = 0; e < kRW; ++e) item0[e * lay.item_ld + it] = a[e];
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kRW; ++e) {
      const float* item = item0 + e * lay.item_ld;
      const float* pa = phi0 + e * lay.phi_ld + P + R * D;
      for (int col = lane; col < npd; col += 32) {
        float g;
        if (col < P) {
          float a = 0.f;
          for (int h = 0; h < S; ++h) a += item[col * S + h];
          g = (2.f * pa[col]) * a * c.inv_sqrt_p;
        } else {
          g = item[P * S + col - P];
        }
        // A token past n adds nothing to the sums.
        dproj0[e * lay.dproj_ld + col] = valid[e] ? g : 0.f;
      }
    }
    __syncwarp();

    // dA/dΩ sums (the kRW tokens added in order) and dû = dpa·A + dpw·Ω
    // on the lane's columns, both row by row.
    float duh[kRW][kQ] = {};
    auto add_row = [&](int col, float (&ac)[kQ]) {
      float a[kQ];
      load_cols<kQ>(aw + col * ldw + lane * kQ, a);
#pragma unroll
      for (int e = 0; e < kRW; ++e) {
        const float g = dproj0[e * lay.dproj_ld + col];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          ac[q] += g * uh[e][q];
          duh[e][q] += g * a[q];
        }
      }
    };
    if constexpr (kRegAcc) {
#pragma unroll
      for (int col = 0; col < kRegRows; ++col)
        if (col < npd) add_row(col, acc[col]);
    } else {
      for (int col = 0; col < npd; ++col) {
        float ac[kQ];
        load_cols<kQ>(acc_s + col * ldw + lane * kQ, ac);
        add_row(col, ac);
#pragma unroll
        for (int q = 0; q < kQ; ++q) acc_s[col * ldw + lane * kQ + q] = ac[q];
      }
    }
    // du = inv·(dû − û (ûᵀdû)).
    float dot[kRW];
#pragma unroll
    for (int e = 0; e < kRW; ++e) {
      dot[e] = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) dot[e] += uh[e][q] * duh[e][q];
    }
    warp_sums(dot);
#pragma unroll
    for (int e = 0; e < kRW; ++e) {
      if (!valid[e]) continue;
      T* dut = du + (int64_t)(t0 + e * nw) * d;
      const float ie = phi0[e * lay.phi_ld + 2 * P + R * D];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int col = lane * kQ + q;
        if (col < d) dut[col] = from_f32<T>(ie * (duh[e][q] - uh[e][q] * dot[e]));
      }
    }
    __syncwarp();   // the slot is staged into again
    slot = slot + 1 == kBwdStages ? 0 : slot + 1;
  }
  cp_async_wait_all();

  // The block's dA/dΩ: its warps' sums added in warp order.
  for (int w = 0; w < kBwdWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int i = lane * kQ + q;
        if (i >= d) continue;
        if constexpr (kRegAcc) {
#pragma unroll
          for (int col = 0; col < kRegRows; ++col)
            if (col < npd)
              daw[col * d + i] =
                  w == 0 ? acc[col][q] : daw[col * d + i] + acc[col][q];
        } else {
          for (int col = 0; col < npd; ++col)
            daw[col * d + i] = w == 0 ? acc_s[col * ldw + i]
                                      : daw[col * d + i] +
                                            acc_s[col * ldw + i];
        }
      }
    }
    __syncthreads();
  }
  store_daw(daw, da_out, dw_out, blockIdx.x, d, c);
}

// B8's instantiation for these shapes.
template <typename T, int kQ, bool kRegAcc>
const void* bwd_fn() {
  return reinterpret_cast<const void*>(feature_map_bwd_kernel<T, kQ, kRegAcc>);
}

template <typename T>
const void* fm_bwd_kernel(int d, int P, int D, int R) {
  const BwdLayout l = bwd_layout(d, P, D, R, (int)sizeof(T));
  if (l.reg_acc) return l.kq == 1 ? bwd_fn<T, 1, true>() : bwd_fn<T, 2, true>();
  return l.kq == 1   ? bwd_fn<T, 1, false>()
         : l.kq == 2 ? bwd_fn<T, 2, false>()
                     : bwd_fn<T, 4, false>();
}

inline size_t fm_smem(int d, int P, int D, int R, bool bwd, int es) {
  return (size_t)(bwd ? bwd_layout(d, P, D, R, es).total
                      : fwd_layout(d, P, D, R, es).total);
}

// B7's kernel, or B8's for these shapes, with its dynamic shared memory
// allowed; null if the attribute cannot be set.
template <typename T>
const void* fm_kernel(bool bwd, int d, int P, int D, int R, size_t smem) {
  const void* kern =
      bwd ? fm_bwd_kernel<T>(d, P, D, R)
          : reinterpret_cast<const void*>(feature_map_fwd_kernel<T>);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return nullptr;
  return kern;
}

// The persistent grid of B7 (bwd false) or B8 for n tokens on the current
// device: the blocks that fit on all SMs at once, at most one per tile of
// kFwdTile tokens (B7) or per kBwdWarps tokens (B8). Negative cudaError_t
// on failure.
template <typename T>
int fm_blocks(bool bwd, int n, int d, int P, int D, int R) {
  const size_t smem = fm_smem(d, P, D, R, bwd, (int)sizeof(T));
  const void* kern = fm_kernel<T>(bwd, d, P, D, R, smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = kern == nullptr ? cudaErrorInvalidValue : cudaSuccess;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  const int unit = bwd ? kBwdWarps : kFwdTile;
  const int need = (n + unit - 1) / unit;
  const int full = sms * (per_sm > 0 ? per_sm : 1);
  return need < full ? need : full;
}

template <typename T>
int launch_fm(bool bwd, const void* u, const float* anchors,
              const float* omegas, const void* dpsi, void* out, float* da,
              float* dw, int n, int d, int blocks, PsiConsts c,
              cudaStream_t stream) {
  const size_t smem = fm_smem(d, c.P, c.D, c.R, bwd, (int)sizeof(T));
  const void* kern = fm_kernel<T>(bwd, d, c.P, c.D, c.R, smem);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  if (bwd) {
    void* args[] = {&u, &anchors, &omegas, &dpsi, &out, &da, &dw, &n, &d, &c};
    return (int)cudaLaunchKernel(kern, dim3(blocks), dim3(kThreads), args,
                                 smem, stream);
  }
  feature_map_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(u), anchors, omegas, static_cast<T*>(out), n, d,
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
  auto a = static_cast<const float*>(anchors);
  auto w = static_cast<const float*>(omegas);
  auto pda = static_cast<float*>(da);
  auto pdw = static_cast<float*>(dw);
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (dtype == 0) {
    if (!bwd) blocks = fm_blocks<float>(false, n, d, P, D, R);
    if (blocks < 0) return -blocks;
    return launch_fm<float>(bwd, u, a, w, dpsi, out, pda, pdw, n, d, blocks, c,
                            st);
  }
  if (dtype == 1) {
    if (!bwd) blocks = fm_blocks<__nv_bfloat16>(false, n, d, P, D, R);
    if (blocks < 0) return -blocks;
    return launch_fm<__nv_bfloat16>(bwd, u, a, w, dpsi, out, pda, pdw, n, d,
                                    blocks, c, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace slay

extern "C" {

// Bytes of dynamic shared memory one block of B7 (bwd 0) or B8 (bwd 1)
// needs at these shapes, for u in fp32 (dtype 0) or bf16 (dtype 1).
long long slay_feature_map_smem_bytes(int d, int P, int D, int R, int bwd,
                                      int dtype) {
  return (long long)slay::fm_smem(d, P, D, R, bwd != 0, dtype == 1 ? 2 : 4);
}

// Blocks of B8's persistent grid for n tokens on the current device, and
// so the rows of its dA/dΩ partials; a negative cudaError_t on failure.
int slay_feature_map_bwd_blocks(int n, int d, int P, int D, int R,
                                int dtype) {
  if (dtype == 0) return slay::fm_blocks<float>(true, n, d, P, D, R);
  if (dtype == 1) return slay::fm_blocks<__nv_bfloat16>(true, n, d, P, D, R);
  return -(int)cudaErrorInvalidValue;
}

// How B8 sits on the current device at these shapes (block_residency;
// out[5] the warps per block, one token each at a time).
int slay_feature_map_bwd_occupancy(int d, int P, int D, int R, int dtype,
                                   int* out) {
  const int es = dtype == 1 ? 2 : 4;
  const size_t smem = slay::fm_smem(d, P, D, R, true, es);
  const void* kern =
      dtype == 0   ? slay::fm_bwd_kernel<float>(d, P, D, R)
      : dtype == 1 ? slay::fm_bwd_kernel<__nv_bfloat16>(d, P, D, R)
                   : nullptr;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return slay::block_residency(kern, slay::kThreads, smem, slay::kBwdWarps,
                               out);
}

// How B7 sits on the current device at these shapes (block_residency;
// out[5] the tokens per tile; its grid is the blocks resident at once, at
// most one per tile).
int slay_feature_map_fwd_occupancy(int d, int P, int D, int R, int dtype,
                                   int* out) {
  const size_t smem = slay::fm_smem(d, P, D, R, false, dtype == 1 ? 2 : 4);
  const void* kern =
      dtype == 0   ? reinterpret_cast<const void*>(
                         slay::feature_map_fwd_kernel<float>)
      : dtype == 1 ? reinterpret_cast<const void*>(
                         slay::feature_map_fwd_kernel<__nv_bfloat16>)
                   : nullptr;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return slay::block_residency(kern, slay::kThreads, smem, slay::kFwdTile,
                               out);
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
