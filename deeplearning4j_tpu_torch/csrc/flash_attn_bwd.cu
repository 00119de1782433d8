// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three TPU kernels of `_flash_fused_bwd_impl` in
// deeplearning4j_tpu/nd/pallas_kernels.py (:229-436):
//   - flash_bwd_delta  <- `_flash_bwd_delta_kernel` (:229):
//       delta = rowsum(f32(dO) * f32(O)), one f32 per (batch*head, row);
//   - flash_bwd_dkv    <- `_flash_bwd_dkv_kernel` (:241): one block per
//       (batch*head, key tile) loops over the query tiles and accumulates
//       dV += P^T dO and dK += dS^T Q;
//   - flash_bwd_dq     <- `_flash_bwd_dq_kernel` (:311): one block per
//       (batch*head, query tile) loops over the key tiles up to the
//       forward's causal bound and accumulates dQ += dS K.
// The probabilities are rebuilt from the forward's logsumexp residual, so
// there is no forward re-run and no [S, S] matrix in device memory.
//
// Numerics kept from the TPU kernels where they decide the answer (they
// differ from the forward's: q is not pre-rounded here):
//   - s = (f32(q) . f32(k)^T) * scale, in f32, the scale applied after the
//     product;
//   - causal-masked scores are -1e30, so p = exp(s - lse) is exactly 0;
//   - p = exp(s - lse), dp = f32(dO) . f32(v)^T, ds = p * (dp - delta) *
//     scale and every accumulator are f32;
//   - dQ, dK, dV are rounded once, to the input type, when stored.
// Rows and keys past a ragged end of the sequence get p = 0 and are never
// stored, so any S runs here (the TPU path recomputed instead).
// `attention_block_skip` changes no value on the TPU (the diagonal split
// only skips a select that is the identity below the diagonal), so the
// kernels skip fully masked tiles and mask (every visited tile in the f32
// bodies, only tiles that cross the diagonal or the ragged end in the bf16
// bodies) whatever the flag says.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s f32, 3.35 TB/s):
//   dkv: max(8*B*H*S^2*D*(1/2 if causal) / peak,
//            (6*B*S*H*D*bytes + 8*B*H*S) / 3.35e12)
//   dq:  max(6*B*H*S^2*D*(1/2 if causal) / peak,
//            (5*B*S*H*D*bytes + 8*B*H*S) / 3.35e12)
//   delta: (2*B*S*H*D*bytes + 4*B*H*S) / 3.35e12
// At the training shape (B=32, S=512, H=16, D=128, bf16, causal) all three
// are bound by bytes against the bf16 peak.
//
// Design. The TPU grid's sequential axis becomes a loop over the other
// side's tiles inside a block.
//   - bf16 dK/dV (the training path): flash_bwd_dkv_tma_kernel, TMA ring,
//     wgmma, warp specialisation, and p and ds at f32 fidelity through a
//     hi/lo bf16 split; D of 64 or 128 (the wrapper zero-pads other head
//     dims). See its section below.
//   - bf16 dQ (the training path): flash_bwd_dq_tma_kernel, the same design
//     mirrored for queries: a ring of K and V tiles, S and dP on wgmma, ds
//     split into hi/lo bf16 for dQ += dS.K on wgmma with K read in place;
//     D of 64 or 128. See its section below.
//   - f32: flash_bwd_dkv_kernel and flash_bwd_dq_kernel do every product
//     with scalar f32 FMAs (the tensor cores would round f32 operands to
//     tf32). Tiles are widened to f32 in shared memory; each thread owns
//     4 query rows x 4 key columns of the score tile and 4 rows x DMAX/16
//     columns of its accumulators. Rows are padded to an odd length
//     (DMAX + 1 floats), so column reads across a warp are free of bank
//     conflicts; one 150-170 KB block fits on an SM at head_dim 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using hopper::bf16;

using hopper::kMaxDevices;
using hopper::set_smem_once;

constexpr int kTile = 64;             // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kLdp = kTile + 1;       // padded row of a score tile
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Stage up to kTile rows of a [*, D] f32 head slice (row stride `ss`
// elements) into a [kTile][LD] shared tile; rows at or past `valid` are 0.
template <int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int valid, int D) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * LD + d] = r < valid ? src[r * ss + d] : 0.f;
  }
}

// The per-row lse and delta of one query tile, 0 past the sequence.
__device__ __forceinline__ void load_rows(float* lse_t, float* delta_t,
                                          const float* lse,
                                          const float* delta,
                                          long long row0, int valid) {
  if (threadIdx.x < kTile) {
    const bool in = (int)threadIdx.x < valid;
    lse_t[threadIdx.x] = in ? lse[row0 + threadIdx.x] : 0.f;
    delta_t[threadIdx.x] = in ? delta[row0 + threadIdx.x] : 0.f;
  }
}

// p and ds of one thread's 4 x 4 part of a 64 x 64 score tile: query rows
// ty + 16 i of the tile at q0, key columns tx + 16 c of the tile at k0.
// Both tiles are staged; s and dp are their f32 dot products over D.
template <int LD>
__device__ __forceinline__ void scores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_t, const float* delta_t, int q0, int k0, int S, int D,
    float scale, int causal, int tx, int ty, float (&p)[4][4],
    float (&ds)[4][4]) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[i][c] = 0.f;
      dp[i][c] = 0.f;
    }
  for (int d = 0; d < D; ++d) {
    float qr[4], dor[4], kr[4], vr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qr[i] = Qs[(ty + 16 * i) * LD + d];
      dor[i] = dOs[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kr[c] = Ks[(tx + 16 * c) * LD + d];
      vr[c] = Vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = fmaf(qr[i], kr[c], s[i][c]);
        dp[i][c] = fmaf(dor[i], vr[c], dp[i][c]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k0 + tx + 16 * c;
      float sv = s[i][c] * scale;
      if (causal && kpos > qpos) sv = kNegBig;
      const float pv =
          (qpos < S && kpos < S) ? expf(sv - lse_t[r]) : 0.f;
      p[i][c] = pv;
      ds[i][c] = pv * (dp[i][c] - delta_t[r]) * scale;
    }
  }
}

// ------------------------------------------------------------------ delta

constexpr int kDeltaRows = kThreads / 32;  // one warp per row

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int H, int S, int D,
                       long long o_sb, long long o_ss, long long do_sb,
                       long long do_ss, long long rows) {
  const long long row =
      (long long)blockIdx.x * kDeltaRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bh = row / S;
  const int s = (int)(row - bh * S);
  const long long b = bh / H;
  const int h = (int)(bh - b * H);
  const T* orow = o + b * o_sb + s * o_ss + (long long)h * D;
  const T* drow = dout + b * do_sb + s * do_ss + (long long)h * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------------------- f32: dkv

template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (DMAX + 1) + 2 * kTile * kLdp +
                          2 * kTile);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int S, int D, long long q_sb,
                     long long q_ss, long long k_sb, long long k_ss,
                     long long v_sb, long long v_ss, long long do_sb,
                     long long do_ss, float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int kOut = DMAX / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                  // [kTile][LD]
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;      // [query][key], kLdp
  float* dSs = Ps + kTile * kLdp;
  float* lse_t = dSs + kTile * kLdp;
  float* delta_t = lse_t + kTile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x & 15;  // key column group; output column group
  const int ty = threadIdx.x >> 4;  // query row group; key row group

  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;
  const float* db = dout + b * do_sb + (long long)h * D;

  load_tile<LD>(Ks, kb + k0 * k_ss, k_ss, S - k0, D);
  load_tile<LD>(Vs, vb + k0 * v_ss, v_ss, S - k0, D);

  float acc_k[4][kOut], acc_v[4][kOut];  // key rows ty + 16 i, cols tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      acc_k[i][c] = 0.f;
      acc_v[i][c] = 0.f;
    }

  const int nq = (S + kTile - 1) / kTile;
  // query tiles that end before this tile's first key are fully masked
  const int first = causal ? blockIdx.y : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's P and dS are consumed
    load_tile<LD>(Qs, qb + q0 * q_ss, q_ss, S - q0, D);
    load_tile<LD>(dOs, db + q0 * do_ss, do_ss, S - q0, D);
    load_rows(lse_t, delta_t, lse, delta, (long long)bh * S + q0, S - q0);
    __syncthreads();

    float p[4][4], ds[4][4];
    scores<LD>(Qs, dOs, Ks, Vs, lse_t, delta_t, q0, k0, S, D, scale, causal,
               tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Ps[(ty + 16 * i) * kLdp + tx + 16 * c] = p[i][c];
        dSs[(ty + 16 * i) * kLdp + tx + 16 * c] = ds[i][c];
      }
    __syncthreads();

    // dV[key][d] += sum_q P[q][key] dO[q][d];  dK[key][d] += dS[q][key] Q[q][d]
    for (int r = 0; r < kTile; ++r) {
      float pr[4], dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = Ps[r * kLdp + ty + 16 * i];
        dsr[i] = dSs[r * kLdp + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float dov = dOs[r * LD + d];
          const float qv = Qs[r * LD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pr[i], dov, acc_v[i][c]);
            acc_k[i][c] = fmaf(dsr[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

  const long long ss = (long long)H * D;  // outputs: contiguous [B, S, H, D]
  float* dkb = dk + (long long)b * S * ss + (long long)h * D;
  float* dvb = dv + (long long)b * S * ss + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= S) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dkb[kpos * ss + d] = acc_k[i][c];
        dvb[kpos * ss + d] = acc_v[i][c];
      }
    }
  }
}

// -------------------------------------------------------------- f32: dq

template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (DMAX + 1) + kTile * kLdp + 2 * kTile);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int S, int D, long long q_sb, long long q_ss,
                    long long k_sb, long long k_ss, long long v_sb,
                    long long v_ss, long long do_sb, long long do_ss,
                    float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int kOut = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kTile][LD]
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;      // [query][key], kLdp
  float* lse_t = dSs + kTile * kLdp;
  float* delta_t = lse_t + kTile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;
  const float* db = dout + b * do_sb + (long long)h * D;

  load_tile<LD>(Qs, qb + q0 * q_ss, q_ss, S - q0, D);
  load_tile<LD>(dOs, db + q0 * do_ss, do_ss, S - q0, D);
  load_rows(lse_t, delta_t, lse, delta, (long long)bh * S + q0, S - q0);

  float acc[4][kOut];  // query rows ty + 16 i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;

  int nk = (S + kTile - 1) / kTile;
  // the forward's bound: key tiles past this tile's last query add nothing
  if (causal) nk = nk < (int)blockIdx.y + 1 ? nk : (int)blockIdx.y + 1;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the last tile's K and dS are consumed
    load_tile<LD>(Ks, kb + k0 * k_ss, k_ss, S - k0, D);
    load_tile<LD>(Vs, vb + k0 * v_ss, v_ss, S - k0, D);
    __syncthreads();

    float p[4][4], ds[4][4];
    scores<LD>(Qs, dOs, Ks, Vs, lse_t, delta_t, q0, k0, S, D, scale, causal,
               tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dSs[(ty + 16 * i) * kLdp + tx + 16 * c] = ds[i][c];
    __syncthreads();

    // dQ[q][d] += sum_key dS[q][key] K[key][d]
    for (int r = 0; r < kTile; ++r) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = dSs[(ty + 16 * i) * kLdp + r];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float kv = Ks[r * LD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsr[i], kv, acc[i][c]);
        }
      }
    }
  }

  const long long ss = (long long)H * D;
  float* dqb = dq + (long long)b * S * ss + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dqb[qpos * ss + d] = acc[i][c];
    }
  }
}

// ------------------------------------------------ bf16 dK/dV, TMA + wgmma
//
// One block of three warpgroups per (batch*head, 128-key tile). Warpgroup 2
// produces: `setmaxnreg` gives its registers to the consumers; one thread
// loads K and V once and streams 64-query tiles of Q and dO by TMA, with
// their lse and delta rows (a rank-1 map), into a three-stage ring (full /
// empty mbarriers), twice. Warpgroups 0 and 1 each own 64 keys and make
// two passes over the query tiles, one accumulator each: dV, then dK.
// For each tile, in halves of 32 queries:
//   S^T = K.Q^T (and in the dK pass dP^T = V.dO^T): wgmma m64n32k16, both
//     operands K-major in shared memory (no transpose);
//   P^T = exp(S^T scale - lse) (and dS^T = P^T (dP^T - delta) scale) in
//     f32, on the accumulators, which are already laid out as the next
//     product's A operand: nothing goes through shared memory;
//   dV += P^T.dO or dK += dS^T.Q: wgmma with A from registers and dO or Q
//     read from the ring as the MN-major (transposed) B operand.
// One 64 x D accumulator at a time leaves room beside it for each
// product's contiguous register block: with both, ptxas spills at D = 128.
// The second pass recomputes S. (ptxas still serialises the D = 128 wgmma;
// PERF.md.)
// p and ds keep f32 fidelity on the bf16 tensor cores: each value x is
// split into hi = bf16(x) and lo = bf16(x - hi), and both halves go into
// the same f32 accumulator as two wgmma; the other operand (dO, Q) is an
// exact bf16 input. The error per term is about 2^-17 relative, against
// 2^-9 for one rounding. With the split and the second S, a head takes
// seven [S, S, D] products of tensor work where the TPU kernel takes four:
// about 0.12 ms at the training shape at 989 TFLOP/s, level with the
// 0.12 ms byte bound.

constexpr int kDkvBK = 128;       // keys per block: 2 consumer warpgroups
constexpr int kDkvBQ = 64;        // queries per streamed tile
constexpr int kDkvStages = 3;     // depth of the Q / dO ring
constexpr int kDkvThreads = 384;  // warpgroups 0, 1 consume; 2 produces

// Every box is [rows][64] bf16 with the 128-byte swizzle; the bf16 arrays
// are multiples of 1024 bytes, so each box stays 1024-byte aligned.
template <int D>
struct DkvSmem {
  bf16 k[D / 64][kDkvBK * 64];
  bf16 v[D / 64][kDkvBK * 64];
  bf16 q[kDkvStages][D / 64][kDkvBQ * 64];
  bf16 dout[kDkvStages][D / 64][kDkvBQ * 64];
  float lse[kDkvStages][kDkvBQ];
  float delta[kDkvStages][kDkvBQ];
  uint64_t kv_full;
  uint64_t full[kDkvStages], empty[kDkvStages];
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_lse,
                         const __grid_constant__ CUtensorMap tm_delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int S, float scale, int causal) {
  using namespace hopper;
  constexpr int kBoxes = D / 64;
  constexpr uint32_t kKBox = kDkvBK * 128, kQBox = kDkvBQ * 128;  // bytes
  constexpr uint32_t kTileBytes = 2 * kBoxes * kQBox + 2 * kDkvBQ * 4;
  extern __shared__ char tma_smem[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(align_1024(tma_smem));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // blocks start in the order of blockIdx.y, and under causal masking the
  // first key tiles meet the most query tiles: the heaviest go first
  const int k0 = blockIdx.y * kDkvBK;
  const int nq = (S + kDkvBQ - 1) / kDkvBQ;
  // query tiles that end before this tile's first key are fully masked
  const int first = causal ? k0 / kDkvBQ : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int st = 0; st < kDkvStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread loads K and V once and keeps the ring full
    regs_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_do);
      mbar_expect_tx(&sm.kv_full, 2 * kBoxes * kKBox);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_4d(sm.k[c], &tm_k, &sm.kv_full, 64 * c, h, k0, b);
        tma_load_4d(sm.v[c], &tm_v, &sm.kv_full, 64 * c, h, k0, b);
      }
      // the query tiles twice: the dV pass, then the dK pass
      for (int i = 0; i < 2 * (nq - first); ++i) {
        const int st = i % kDkvStages;
        const int q0 = (first + i % (nq - first)) * kDkvBQ;
        mbar_wait(&sm.empty[st], ((i / kDkvStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], kTileBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(sm.q[st][c], &tm_q, &sm.full[st], 64 * c, h, q0, b);
          tma_load_4d(sm.dout[st][c], &tm_do, &sm.full[st], 64 * c, h, q0,
                      b);
        }
        // rows past S read the next head's values (or zeros past the
        // end); their p is masked to 0
        tma_load_1d(sm.lse[st], &tm_lse, &sm.full[st], bh * S + q0);
        tma_load_1d(sm.delta[st], &tm_delta, &sm.full[st], bh * S + q0);
      }
    }
  } else {
    // consumers: warpgroup wg owns keys kw0 .. kw0 + 63, the accumulators'
    // rows; the query tile is their columns
    regs_inc<240>();
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int kw0 = k0 + 64 * wg;
    const int key_lo = kw0 + 16 * warp + lane / 4;  // keys key_lo, key_lo + 8
    const int t2 = 2 * (lane % 4);
    const float scale_l2 = scale * kLog2e;

    const uint64_t k_desc = desc_sw128(sm.k[0] + 64 * 64 * wg, 16, 1024);
    const uint64_t v_desc = desc_sw128(sm.v[0] + 64 * 64 * wg, 16, 1024);
    const long long ss = (long long)H * D;  // outputs: contiguous [B,S,H,D]
    const long long out0 = (long long)b * S * ss + (long long)h * D;
    mbar_wait(&sm.kv_full, 0);

    // two passes over the query tiles, one accumulator each (see above):
    // dV, which needs only S, then dK, which needs S and dP
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float acc[D / 2];
#pragma unroll
      for (int a = 0; a < D / 2; ++a) acc[a] = 0.f;
      for (int t = 0; t < nq - first; ++t) {
        const int i = pass * (nq - first) + t;
        const int st = i % kDkvStages;
        const int q0 = (first + t) * kDkvBQ;
        mbar_wait(&sm.full[st], (i / kDkvStages) & 1);
        // a tile whose every query comes before every key here adds nothing
        if (!(causal && q0 + kDkvBQ - 1 < kw0)) {
          const bool masked = (causal && kw0 + 63 > q0) ||
                              q0 + kDkvBQ > S || kw0 + 64 > S;
          const uint64_t qd = desc_sw128(sm.q[st][0], 16, 1024);
          const uint64_t dod = desc_sw128(sm.dout[st][0], 16, 1024);
          // dO (dV pass) or Q (dK pass) as the MN-major B operand
          const uint64_t bd = desc_sw128(pass == 0 ? sm.dout[st][0]
                                                   : sm.q[st][0],
                                         kQBox, 1024);
          // two halves of 32 queries, one half's scores and fragments live
          // at a time
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            // S^T = K.Q^T (and, in the dK pass, dP^T = V.dO^T) for queries
            // 32 hf .. 32 hf + 31; each descriptor is rebuilt just before
            // its wgmma (`fresh`): computed at once they overflow the
            // uniform registers
            float s[16], dp[16];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              // columns 16 kk ..: box kk / 4, 32 bytes a k-step in its
              // rows; the half's 32 query rows start 4096 bytes in the box
              const uint32_t off = (kk % 4) * 32;
              wgmma_ss_n32(s, desc_at(fresh(k_desc), (kk / 4) * kKBox + off),
                           desc_at(fresh(qd),
                                   (kk / 4) * kQBox + hf * 4096 + off),
                           kk);
            }
            if (pass == 1) {
#pragma unroll
              for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                wgmma_ss_n32(dp,
                             desc_at(fresh(v_desc), (kk / 4) * kKBox + off),
                             desc_at(fresh(dod),
                                     (kk / 4) * kQBox + hf * 4096 + off),
                             kk);
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);
            if (pass == 1) fence_regs(dp);

            // p (and ds) in f32, with the TPU kernel's masking where a tile
            // crosses the diagonal or a ragged end (p = 0 there): element
            // 8 kl + 2 x + c is key key_lo + 8 (x & 1) and query 32 hf +
            // 16 kl + 8 (x >> 1) + t2 + c of the tile
#pragma unroll
            for (int kl = 0; kl < 2; ++kl)
#pragma unroll
              for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const int e = 8 * kl + 2 * x + c;
                  const int ql = 32 * hf + 16 * kl + 8 * (x >> 1) + t2 + c;
                  float pv = exp2f(fmaf(s[e], scale_l2,
                                        -sm.lse[st][ql] * kLog2e));
                  if (masked) {
                    const int qpos = q0 + ql, kpos = key_lo + 8 * (x & 1);
                    if ((causal && kpos > qpos) || qpos >= S || kpos >= S)
                      pv = 0.f;
                  }
                  s[e] = pass == 0
                             ? pv
                             : pv * (dp[e] - sm.delta[st][ql]) * scale;
                }

            // acc += P^T.dO or dS^T.Q over this half's 32 queries, each
            // value split into hi and lo A fragments of k-step kl
            uint32_t hi[2][4], lo[2][4];
#pragma unroll
            for (int kl = 0; kl < 2; ++kl)
#pragma unroll
              for (int x = 0; x < 4; ++x)
                split_bf16x2(s[8 * kl + 2 * x], s[8 * kl + 2 * x + 1],
                             hi[kl][x], lo[kl][x]);
            wgmma_fence();
#pragma unroll
            for (int kl = 0; kl < 2; ++kl) {
              const uint64_t bb = desc_at(bd, (2 * hf + kl) * 2048);
              if constexpr (D == 128) {
                wgmma_rs_n128(acc, hi[kl], bb);
                wgmma_rs_n128(acc, lo[kl], bb);
              } else {
                wgmma_rs_n64(acc, hi[kl], bb);
                wgmma_rs_n64(acc, lo[kl], bb);
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(hi);
            fence_regs(lo);
          }
        }
        if (lane == 0) mbar_arrive(&sm.empty[st]);
      }

      // dV, then dK, rounded once to bf16; keys past S are never stored
      bf16* out = (pass == 0 ? dv : dk) + out0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key_lo + 8 * r;
        if (key >= S) continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(out + key * ss + 8 * n + t2) =
              pack_bf16x2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      }
    }
  }
}

// --------------------------------------------------- bf16 dQ, TMA + wgmma
//
// The dK/dV body mirrored for queries. One block of three warpgroups per
// (batch*head, 128-query tile). Warpgroup 2 produces: `setmaxnreg` gives its
// registers to the consumers; one thread loads the block's Q and dO once,
// with their lse and delta rows (a rank-1 map), and streams 64-key tiles of
// K and V by TMA into a three-stage ring (full / empty mbarriers), up to
// the forward's causal bound (`nk_needed`). Warpgroups 0 and 1 each own 64
// queries, the rows of every accumulator. For each key tile:
//   S = Q.K^T and dP = dO.V^T: wgmma m64n64k16, both operands K-major in
//     shared memory (no transpose);
//   p = exp(S scale - lse) and dS = p (dP - delta) scale in f32 on the
//     accumulators; the masks run only on tiles that cross the diagonal or
//     a ragged end (the TPU kernel's `nk_full` split);
//   dQ += dS.K: wgmma with A from registers (the accumulator of S is laid
//     out as an A operand already) and K read from the ring as the MN-major
//     B operand, as V is for P.V in the forward. Nothing goes through
//     shared memory.
// dS keeps f32 fidelity as in dK/dV: hi = bf16(ds) and lo = bf16(ds - hi)
// both go into the f32 accumulator, two wgmma per k-step. Registers: the
// 64 x D accumulator (D / 2 a thread) beside S and dP (32 each); the
// 64-key tile keeps that under the consumers' 240 without spills. A head
// then issues four [S, S, D] products of tensor work where the TPU kernel
// issues three.

constexpr int kDqBQ = 128;       // queries per block: 2 consumer warpgroups
constexpr int kDqBK = 64;        // keys per streamed tile
constexpr int kDqStages = 3;     // depth of the K / V ring
constexpr int kDqThreads = 384;  // warpgroups 0, 1 consume; 2 produces

// Every box is [rows][64] bf16 with the 128-byte swizzle; the bf16 arrays
// are multiples of 1024 bytes, so each box stays 1024-byte aligned.
template <int D>
struct DqSmem {
  bf16 q[D / 64][kDqBQ * 64];
  bf16 dout[D / 64][kDqBQ * 64];
  bf16 k[kDqStages][D / 64][kDqBK * 64];
  bf16 v[kDqStages][D / 64][kDqBK * 64];
  float lse[kDqBQ];
  float delta[kDqBQ];
  uint64_t q_full;
  uint64_t full[kDqStages], empty[kDqStages];
};

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_lse,
                        const __grid_constant__ CUtensorMap tm_delta,
                        bf16* __restrict__ dq, int H, int S, float scale,
                        int causal) {
  using namespace hopper;
  constexpr int kBoxes = D / 64;
  constexpr uint32_t kQBox = kDqBQ * 128, kKBox = kDqBK * 128;  // bytes
  extern __shared__ char tma_smem[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(align_1024(tma_smem));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // the causal work of a query tile grows with its index, and blocks start
  // in the order of blockIdx.y: the heaviest tiles go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqBQ;
  int nk = (S + kDqBK - 1) / kDqBK;
  if (causal) {
    // the forward's bound: key tiles past this tile's last query add nothing
    const int needed = (q0 + kDqBQ + kDqBK - 1) / kDqBK;
    nk = nk < needed ? nk : needed;
  }
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread loads Q, dO, lse, delta once and keeps the ring
    // of K and V tiles full
    regs_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_do);
      mbar_expect_tx(&sm.q_full, 2 * kBoxes * kQBox + 2 * kDqBQ * 4);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_4d(sm.q[c], &tm_q, &sm.q_full, 64 * c, h, q0, b);
        tma_load_4d(sm.dout[c], &tm_do, &sm.q_full, 64 * c, h, q0, b);
      }
      // rows past S read the next head's values (or zeros past the end);
      // their p is masked to 0 and they are never stored
      tma_load_1d(sm.lse, &tm_lse, &sm.q_full, bh * S + q0);
      tma_load_1d(sm.delta, &tm_delta, &sm.q_full, bh * S + q0);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kDqStages;
        mbar_wait(&sm.empty[st], ((j / kDqStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * kBoxes * kKBox);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(sm.k[st][c], &tm_k, &sm.full[st], 64 * c, h,
                      j * kDqBK, b);
          tma_load_4d(sm.v[st][c], &tm_v, &sm.full[st], 64 * c, h,
                      j * kDqBK, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns queries qw0 .. qw0 + 63
    regs_inc<240>();
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int rl = 64 * wg + 16 * warp + lane / 4;  // block rows rl, rl + 8
    const int qw0 = q0 + 64 * wg;
    const int r_lo = q0 + rl;                       // queries r_lo, r_lo + 8
    const int t2 = 2 * (lane % 4);
    const float scale_l2 = scale * kLog2e;

    mbar_wait(&sm.q_full, 0);
    float lse_l2[2], dlt[2];  // this thread's two rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lse_l2[i] = sm.lse[rl + 8 * i] * kLog2e;
      dlt[i] = sm.delta[rl + 8 * i];
    }
    const uint64_t q_desc = desc_sw128(sm.q[0] + 64 * 64 * wg, 16, 1024);
    const uint64_t do_desc = desc_sw128(sm.dout[0] + 64 * 64 * wg, 16, 1024);
    float acc[D / 2];
#pragma unroll
    for (int a = 0; a < D / 2; ++a) acc[a] = 0.f;

    for (int j = 0; j < nk; ++j) {
      const int st = j % kDqStages;
      const int k0 = j * kDqBK;
      mbar_wait(&sm.full[st], (j / kDqStages) & 1);
      // a tile whose every key comes after every query here adds nothing,
      // nor does a warpgroup whose every query lies past S
      if (!(causal && k0 > qw0 + 63) && qw0 < S) {
        const bool masked = (causal && k0 + kDqBK - 1 > qw0) ||
                            k0 + kDqBK > S || qw0 + 64 > S;
        // S = Q.K^T and dP = dO.V^T, 64 x 64; each descriptor is rebuilt
        // just before its wgmma (`fresh`), as in dK/dV
        const uint64_t kd = desc_sw128(sm.k[st][0], 16, 1024);
        const uint64_t vd = desc_sw128(sm.v[st][0], 16, 1024);
        float s[kDqBK / 2], dp[kDqBK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          // columns 16 kk ..: box kk / 4, 32 bytes a k-step in its rows
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(s, desc_at(fresh(q_desc), (kk / 4) * kQBox + off),
                       desc_at(fresh(kd), (kk / 4) * kKBox + off), kk);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(dp, desc_at(fresh(do_desc), (kk / 4) * kQBox + off),
                       desc_at(fresh(vd), (kk / 4) * kKBox + off), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // p and ds in f32, with the TPU kernel's masking where the tile
        // crosses the diagonal or a ragged end (p = 0 there): element
        // 4 n + 2 i + c is query r_lo + 8 i and key k0 + 8 n + t2 + c
#pragma unroll
        for (int n = 0; n < kDqBK / 8; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * n + 2 * i + c;
              float pv = exp2f(fmaf(s[e], scale_l2, -lse_l2[i]));
              if (masked) {
                const int qpos = r_lo + 8 * i, kpos = k0 + 8 * n + t2 + c;
                if ((causal && kpos > qpos) || qpos >= S || kpos >= S)
                  pv = 0.f;
              }
              s[e] = pv * (dp[e] - dlt[i]) * scale;
            }

        // dQ += dS.K over the tile's 64 keys, k-step kk = keys 16 kk ..,
        // each value split into hi and lo A fragments
        uint32_t hi[kDqBK / 16][4], lo[kDqBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kDqBK / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            split_bf16x2(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1], hi[kk][x],
                         lo[kk][x]);
        // K is [keys][D], D contiguous: the MN-major B operand
        const uint64_t kb = desc_sw128(sm.k[st][0], kKBox, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqBK / 16; ++kk) {
          const uint64_t bb = desc_at(kb, kk * 2048);
          if constexpr (D == 128) {
            wgmma_rs_n128(acc, hi[kk], bb);
            wgmma_rs_n128(acc, lo[kk], bb);
          } else {
            wgmma_rs_n64(acc, hi[kk], bb);
            wgmma_rs_n64(acc, lo[kk], bb);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(hi);
        fence_regs(lo);
      }
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    }

    // dQ rounded once to bf16; queries past S are never stored
    const long long ss = (long long)H * D;  // output: contiguous [B,S,H,D]
    bf16* dqb = dq + (long long)b * S * ss + (long long)h * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_lo + 8 * i;
      if (row >= S) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dqb + row * ss + 8 * n + t2) =
            pack_bf16x2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, S, D;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int DMAX>
cudaError_t launch_dkv_f32(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<DMAX>;
  constexpr size_t smem = dkv_smem<DMAX>();
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = set_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.H, a.S, a.D, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb,
      a.do_ss, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq_f32(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<DMAX>;
  constexpr size_t smem = dq_smem<DMAX>();
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = set_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.S, a.D, a.q_sb,
      a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.scale,
      a.causal);
  return cudaGetLastError();
}

// The six tensor maps of the bf16 TMA bodies: q and dO in boxes of `q_rows`
// rows, k and v in boxes of `k_rows`, lse and delta (rank 1) in boxes of
// `row_box` values. They take D of 64 or 128 on 16-byte aligned rows (the
// wrapper pads other shapes).
struct BwdMaps {
  CUtensorMap q, k, v, dout, lse, delta;
};

cudaError_t bwd_maps(const Args& a, int D, int q_rows, int k_rows,
                     int row_box, BwdMaps* m) {
  using namespace hopper;
  if (a.D != D || !tma_heads_ok(a.q, D, a.q_ss, a.q_sb) ||
      !tma_heads_ok(a.k, D, a.k_ss, a.k_sb) ||
      !tma_heads_ok(a.v, D, a.v_ss, a.v_sb) ||
      !tma_heads_ok(a.dout, D, a.do_ss, a.do_sb))
    return cudaErrorInvalidValue;
  cudaError_t err =
      heads_map(&m->q, a.q, a.B, a.S, a.H, D, a.q_ss, a.q_sb, q_rows);
  if (err == cudaSuccess)
    err = heads_map(&m->k, a.k, a.B, a.S, a.H, D, a.k_ss, a.k_sb, k_rows);
  if (err == cudaSuccess)
    err = heads_map(&m->v, a.v, a.B, a.S, a.H, D, a.v_ss, a.v_sb, k_rows);
  if (err == cudaSuccess)
    err = heads_map(&m->dout, a.dout, a.B, a.S, a.H, D, a.do_ss, a.do_sb,
                    q_rows);
  const long long rows = (long long)a.B * a.H * a.S;
  if (err == cudaSuccess) err = rows_map(&m->lse, a.lse, rows, row_box);
  if (err == cudaSuccess) err = rows_map(&m->delta, a.delta, rows, row_box);
  return err;
}

// DMAX is the head_dim bucket; the bf16 bodies exist for 64 and 128 only
template <int DMAX>
cudaError_t launch_dkv_bf16(const Args& a) {
  if constexpr (DMAX != 64 && DMAX != 128) {
    return cudaErrorInvalidValue;
  } else {
    BwdMaps m;
    cudaError_t err = bwd_maps(a, DMAX, kDkvBQ, kDkvBK, kDkvBQ, &m);
    if (err != cudaSuccess) return err;
    const size_t smem = sizeof(DkvSmem<DMAX>) + 1024;  // + alignment slack
    auto kernel = flash_bwd_dkv_tma_kernel<DMAX>;
    static std::atomic<bool> smem_set[kMaxDevices];
    err = set_smem_once(kernel, smem, smem_set);
    if (err != cudaSuccess) return err;
    dim3 grid(a.B * a.H, (a.S + kDkvBK - 1) / kDkvBK);
    kernel<<<grid, kDkvThreads, smem, a.stream>>>(
        m.q, m.k, m.v, m.dout, m.lse, m.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.H, a.S, a.scale, a.causal);
    return cudaGetLastError();
  }
}

template <int DMAX>
cudaError_t launch_dq_bf16(const Args& a) {
  if constexpr (DMAX != 64 && DMAX != 128) {
    return cudaErrorInvalidValue;
  } else {
    BwdMaps m;
    cudaError_t err = bwd_maps(a, DMAX, kDqBQ, kDqBK, kDqBQ, &m);
    if (err != cudaSuccess) return err;
    const size_t smem = sizeof(DqSmem<DMAX>) + 1024;  // + alignment slack
    auto kernel = flash_bwd_dq_tma_kernel<DMAX>;
    static std::atomic<bool> smem_set[kMaxDevices];
    err = set_smem_once(kernel, smem, smem_set);
    if (err != cudaSuccess) return err;
    dim3 grid(a.B * a.H, (a.S + kDqBQ - 1) / kDqBQ);
    kernel<<<grid, kDqThreads, smem, a.stream>>>(
        m.q, m.k, m.v, m.dout, m.lse, m.delta, static_cast<bf16*>(a.dq),
        a.H, a.S, a.scale, a.causal);
    return cudaGetLastError();
  }
}

// dispatch on the input type (0 = f32: scalar kernels, 1 = bf16: TMA +
// wgmma kernels) and the head_dim bucket
struct DkvLaunch {
  template <int DMAX>
  static cudaError_t f32(const Args& a) { return launch_dkv_f32<DMAX>(a); }
  template <int DMAX>
  static cudaError_t bf16x(const Args& a) { return launch_dkv_bf16<DMAX>(a); }
};
struct DqLaunch {
  template <int DMAX>
  static cudaError_t f32(const Args& a) { return launch_dq_f32<DMAX>(a); }
  template <int DMAX>
  static cudaError_t bf16x(const Args& a) { return launch_dq_bf16<DMAX>(a); }
};

template <typename L>
int dispatch(const Args& a, int dtype) {
  if (a.D < 1 || a.D > 128 || a.S < 1 || a.B < 1 || a.H < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (a.D <= 32) return (int)L::template f32<32>(a);
    if (a.D <= 64) return (int)L::template f32<64>(a);
    return (int)L::template f32<128>(a);
  }
  if (dtype == 1) {
    if (a.D <= 32) return (int)L::template bf16x<32>(a);
    if (a.D <= 64) return (int)L::template bf16x<64>(a);
    return (int)L::template bf16x<128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Layouts, shared by the three entry points:
//   q, k, v, dout: [B, S, H, D] with unit stride over D and stride D over
//     H; their batch and sequence strides (in elements) are passed;
//   lse, delta: contiguous [B*H, S] f32 (the forward's [B*H, S, 1]);
//   dq, dk, dv: contiguous [B, S, H, D] in the input type.
// dtype: 0 = f32, 1 = bf16. Each returns cudaGetLastError() after its launch
// (0 on success).

// delta[bh * S + s] = sum_d f32(o[b, s, h, d]) * f32(dout[b, s, h, d])
extern "C" int flash_bwd_delta(const void* o, const void* dout, void* delta,
                               int B, int H, int S, int D, long long o_sb,
                               long long o_ss, long long do_sb,
                               long long do_ss, int dtype, void* stream) {
  if (D < 1 || S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * S;
  const unsigned blocks = (unsigned)((rows + kDeltaRows - 1) / kDeltaRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_bwd_delta_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), H, S, D, o_sb, o_ss, do_sb, do_ss, rows);
  } else if (dtype == 1) {
    flash_bwd_delta_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        static_cast<float*>(delta), H, S, D, o_sb, o_ss, do_sb, do_ss, rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int H, int S, int D, long long q_sb,
                             long long q_ss, long long k_sb, long long k_ss,
                             long long v_sb, long long v_ss, long long do_sb,
                             long long do_ss, float scale, int causal,
                             int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, dk, dv, B, H, S, D,
         q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, scale, causal,
         static_cast<cudaStream_t>(stream)};
  return dispatch<DkvLaunch>(a, dtype);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int H, int S,
                            int D, long long q_sb, long long q_ss,
                            long long k_sb, long long k_ss, long long v_sb,
                            long long v_ss, long long do_sb, long long do_ss,
                            float scale, int causal, int dtype,
                            void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, B, H, S, D,
         q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, scale, causal,
         static_cast<cudaStream_t>(stream)};
  return dispatch<DqLaunch>(a, dtype);
}
