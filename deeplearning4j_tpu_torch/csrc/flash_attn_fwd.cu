// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_attn_kernel` / `_flash_attention_fwd_impl`
// in deeplearning4j_tpu/nd/pallas_kernels.py (:106-224): online-softmax
// attention of one query tile against every key tile, with no [S, S] score
// matrix in device memory and an optional per-row logsumexp residual.
//
// Numerics kept from the TPU kernel where they decide the answer:
//   - q * scale is rounded in the input type (scale itself rounded to that
//     type first, as a weakly typed scalar is in JAX);
//   - scores, running max m, running sum l and the output accumulator are
//     f32;
//   - causal masking writes -1e30 (not -inf); p is rounded to the input
//     type before the P.V product, while l sums the unrounded p;
//   - o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
// Keys past a ragged end of the sequence are masked in the kernel with -inf
// (p is exactly 0 there), so any S runs here: the TPU path fell back to a
// jax-level blockwise loop for ragged S, this one has no fallback.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//   max(4*B*H*S^2*D*(1/2 if causal) / 989e12, 4*B*S*H*D*bytes / 3.35e12) s.
// At the serving shape (B=8, S=512, H=16, D=128, bf16, causal) the byte
// term is larger: about 67 MB, about 20 us.
//
// Design. The TPU grid's sequential kv axis becomes a loop over key tiles
// inside a block; causal tiles past the diagonal are never visited.
//   - bf16 (the serving and training paths): flash_fwd_tma_kernel, one
//     block of three warpgroups per (batch*head, 128-query tile), D of 64
//     or 128 (the wrapper zero-pads other head dims). Warpgroup 2 is the
//     producer: `setmaxnreg` gives its registers to the consumers, and one
//     of its threads loads Q once and streams 128-key K and V tiles by TMA
//     (rank-4 tensor maps over the strided [B, S, H, D] views, [rows][64]
//     boxes, 128-byte swizzle, zeros past S) into a two-stage ring with
//     full / empty mbarriers, so loads overlap the products. Warpgroups 0
//     and 1 each own 64 query rows: S = (q*scale).K^T is wgmma m64n128k16
//     with both operands K-major in shared memory; the online softmax runs
//     on the f32 accumulators in base 2 (exp2f, log2(e) folded into the
//     scores); P, rounded to bf16 in registers, is the A operand of
//     O += P.V (wgmma, V the MN-major B operand read in place). Masks run
//     only on tiles that cross the diagonal or the ragged end (elsewhere
//     the select is the identity, the TPU kernel's block_skip), and the
//     heaviest causal query tiles launch first. The bound at the path's
//     shapes is bytes; what is left between the kernel and it is the
//     softmax between the two products (no ping-pong of the two warpgroups
//     yet) and the unstaged output stores: PERF.md.
//   - f32: flash_fwd_kernel, scalar f32 FMAs on the CUDA cores (the tensor
//     cores would round f32 operands to tf32). 256 threads, 32-key tiles;
//     each thread owns 4 query rows x 2 key columns of the score tile and
//     4 rows x DMAX/16 output columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using hopper::kMaxDevices;
using hopper::set_smem_once;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr int kCols = kBlockK / 16;  // key columns per thread
constexpr float kNegBig = -1e30f;

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int S, int D,
                 long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss,
                 float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // padded row: conflict-free column reads
  float* Qs = smem;                     // [kBlockQ][D + 1]
  float* Ks = Qs + kBlockQ * ld;        // [kBlockK][D + 1]
  float* Vs = Ks + kBlockK * ld;        // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;         // [kBlockQ][kBlockK + 1]
  const int ldp = kBlockK + 1;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // key / output column group
  const int ty = tid >> 4;   // query row group

  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int qp = q0 + r;
    float val = 0.f;
    if (qp < S) val = qb[qp * q_ss + d] * scale;
    Qs[r * ld + d] = val;
  }

  constexpr int kOut = DMAX / 16;  // output columns per thread
  float acc[kRows][kOut];
  float m[kRows];
  float l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  int nk = (S + kBlockK - 1) / kBlockK;
  if (causal) {
    // tiles whose first key lies past this tile's last query add nothing
    const int needed = (q0 + kBlockQ + kBlockK - 1) / kBlockK;
    nk = nk < needed ? nk : needed;
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // Q staged (j == 0); last tile's K/V/P consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < S) {
        kv = kb[kp * k_ss + d];
        vv = vb[kp * v_ss + d];
      }
      Ks[r * ld + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qr[kRows], kr[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qr[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kr[c] = Ks[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qr[i], kr[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegBig;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kpos = k0 + tx + 16 * c;
        if (kpos >= S) {
          s[i][c] = -INFINITY;
        } else if (causal && kpos > qpos) {
          s[i][c] = kNegBig;
        }
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[i][c] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * ldp + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int oc = 0; oc < kOut; ++oc) {
        const int d = tx + 16 * oc;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][oc] = fmaf(pr[i], vv, acc[i][oc]);
        }
      }
    }
  }

  const long long o_ss = (long long)H * D;
  float* ob = o + (long long)b * S * o_ss + (long long)h * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int oc = 0; oc < kOut; ++oc) {
      const int d = tx + 16 * oc;
      if (d < D) ob[qpos * o_ss + d] = acc[i][oc] / lc;
    }
    if (lse != nullptr && tx == 0) lse[(long long)bh * S + qpos] = m[i] + logf(lc);
  }
}

// -------------------------------------------------------- bf16, TMA + wgmma

using hopper::bf16;

constexpr int kTmaBM = 128;       // queries per block: 2 consumer warpgroups
constexpr int kTmaBN = 128;       // keys per tile
constexpr int kTmaStages = 2;     // depth of the K/V ring
constexpr int kTmaThreads = 384;  // warpgroups 0, 1 consume; 2 produces

// Every box is [rows][64] bf16 with the 128-byte swizzle; every array size
// is a multiple of 1024 bytes, so each box stays 1024-byte aligned.
template <int D>
struct FwdSmem {
  bf16 q[D / 64][kTmaBM * 64];
  bf16 k[kTmaStages][D / 64][kTmaBN * 64];
  bf16 v[kTmaStages][D / 64][kTmaBN * 64];
  uint64_t q_full;
  uint64_t k_full[kTmaStages], v_full[kTmaStages], empty[kTmaStages];
};

union Pack8 {  // 8 bf16 = one 16-byte load or store
  uint4 u;
  bf16 h[8];
};

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     bf16* __restrict__ o, float* __restrict__ lse, int H,
                     int S, float scale, int causal) {
  using namespace hopper;
  constexpr int kBoxes = D / 64;
  constexpr uint32_t kQBox = kTmaBM * 128, kKBox = kTmaBN * 128;  // bytes
  extern __shared__ char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(align_1024(smem_raw));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // the causal work of a query tile grows with its index, and blocks start
  // in the order of blockIdx.y: the heaviest tiles go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTmaBM;
  int nk = (S + kTmaBN - 1) / kTmaBN;
  if (causal) {
    // tiles whose first key lies past this tile's last query add nothing
    const int needed = (q0 + kTmaBM + kTmaBN - 1) / kTmaBN;
    nk = nk < needed ? nk : needed;
  }
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int st = 0; st < kTmaStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.empty[st], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    regs_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(&sm.q_full, kBoxes * kQBox);
      for (int c = 0; c < kBoxes; ++c)
        tma_load_4d(sm.q[c], &tm_q, &sm.q_full, 64 * c, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kTmaStages;
        mbar_wait(&sm.empty[st], ((j / kTmaStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[st], kBoxes * kKBox);
        for (int c = 0; c < kBoxes; ++c)
          tma_load_4d(sm.k[st][c], &tm_k, &sm.k_full[st], 64 * c, h,
                      j * kTmaBN, b);
        mbar_expect_tx(&sm.v_full[st], kBoxes * kKBox);
        for (int c = 0; c < kBoxes; ++c)
          tma_load_4d(sm.v[st][c], &tm_v, &sm.v_full[st], 64 * c, h,
                      j * kTmaBN, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows qw0 .. qw0 + 63
    regs_inc<240>();
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int qw0 = q0 + 64 * wg;
    const int r_lo = qw0 + 16 * warp + lane / 4;  // rows r_lo and r_lo + 8
    const int t2 = 2 * (lane % 4);

    // q * scale rounded to bf16 (the scale rounded first, as a weakly typed
    // scalar is in JAX), in place on this warpgroup's rows of each box; the
    // swizzle moves whole 16-byte chunks, so the rows are contiguous bytes
    mbar_wait(&sm.q_full, 0);
    const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
    for (int c = 0; c < kBoxes; ++c) {
      uint4* rows = reinterpret_cast<uint4*>(sm.q[c] + 64 * 64 * wg);
      for (int i = tid; i < 64 * 64 / 8; i += 128) {
        Pack8 p;
        p.u = rows[i];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          p.h[e] = __float2bfloat16_rn(__bfloat162float(p.h[e]) * scale_t);
        rows[i] = p.u;
      }
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);

    const uint64_t q_desc = desc_sw128(sm.q[0] + 64 * 64 * wg, 16, 1024);
    float acc[D / 2];
#pragma unroll
    for (int a = 0; a < D / 2; ++a) acc[a] = 0.f;
    float m[2] = {kNegBig, kNegBig};  // rows r_lo and r_lo + 8
    float l[2] = {0.f, 0.f};          // this thread's part of the row sums

    for (int j = 0; j < nk; ++j) {
      const int st = j % kTmaStages;
      const uint32_t par = (j / kTmaStages) & 1;
      const int k0 = j * kTmaBN;

      // s = (q * scale) . k^T: 64 x kTmaBN, K-major operands
      float s[kTmaBN / 2];
      const uint64_t qd = fresh(q_desc);
      const uint64_t kd = desc_sw128(sm.k[st][0], 16, 1024);
      mbar_wait(&sm.k_full[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // columns 16 kk ..: box kk / 4, 32 bytes a k-step within its rows
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n128(s, desc_at(qd, (kk / 4) * kQBox + off),
                      desc_at(kd, (kk / 4) * kKBox + off), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // masks only where a tile crosses the diagonal or the ragged end:
      // elsewhere they select every score unchanged
      if (k0 + kTmaBN > S || (causal && k0 + kTmaBN - 1 > qw0)) {
#pragma unroll
        for (int n = 0; n < kTmaBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * n + t2 + (e & 1);
            if (kpos >= S) {
              s[4 * n + e] = -INFINITY;
            } else if (causal && kpos > r_lo + 8 * (e >> 1)) {
              s[4 * n + e] = kNegBig;
            }
          }
      }

      // online softmax in base 2: log2(e) folded into the f32 scores
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int a = 0; a < kTmaBN / 2; ++a)
        mx[(a >> 1) & 1] = fmaxf(mx[(a >> 1) & 1], s[a]);
      float alpha[2], ms[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f((m[i] - m_new) * kLog2e);
        m[i] = m_new;
        ms[i] = m_new * kLog2e;
        l[i] *= alpha[i];
      }
      // p rounded to bf16 as the A operand of P.V; l sums the unrounded p
      uint32_t pa[kTmaBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTmaBN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = x & 1;
          const float p0 = exp2f(fmaf(s[8 * kk + 2 * x], kLog2e, -ms[i]));
          const float p1 = exp2f(fmaf(s[8 * kk + 2 * x + 1], kLog2e, -ms[i]));
          l[i] += p0 + p1;
          pa[kk][x] = pack_bf16x2(p0, p1);
        }
#pragma unroll
      for (int a = 0; a < D / 2; ++a) acc[a] *= alpha[(a >> 1) & 1];

      // acc += p . v: V is [keys][D], D contiguous, the MN-major B operand
      const uint64_t v_desc = desc_sw128(sm.v[st][0], kKBox, 1024);
      mbar_wait(&sm.v_full[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTmaBN / 16; ++kk) {
        if constexpr (D == 128)
          wgmma_rs_n128(acc, pa[kk], desc_at(v_desc, kk * 2048));
        else
          wgmma_rs_n64(acc, pa[kk], desc_at(v_desc, kk * 2048));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    }

    const long long o_ss = (long long)H * D;
    bf16* ob = o + (long long)b * S * o_ss + (long long)h * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float lc = fmaxf(l[i], 1e-30f);
      const int row = r_lo + 8 * i;
      if (row >= S) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(ob + row * o_ss + 8 * n + t2) =
            pack_bf16x2(acc[4 * n + 2 * i] / lc, acc[4 * n + 2 * i + 1] / lc);
      if (lse != nullptr && t2 == 0)
        lse[(long long)bh * S + row] = m[i] + logf(lc);
    }
  }
}

template <int D>
cudaError_t launch_tma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int S, long long q_sb,
                       long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, float scale, int causal,
                       cudaStream_t stream) {
  using namespace hopper;
  if (!tma_heads_ok(q, D, q_ss, q_sb) || !tma_heads_ok(k, D, k_ss, k_sb) ||
      !tma_heads_ok(v, D, v_ss, v_sb))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t err = heads_map(&mq, q, B, S, H, D, q_ss, q_sb, kTmaBM);
  if (err == cudaSuccess)
    err = heads_map(&mk, k, B, S, H, D, k_ss, k_sb, kTmaBN);
  if (err == cudaSuccess)
    err = heads_map(&mv, v, B, S, H, D, v_ss, v_sb, kTmaBN);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(FwdSmem<D>) + 1024;  // + alignment slack
  auto kernel = flash_fwd_tma_kernel<D>;
  static std::atomic<bool> smem_set[kMaxDevices];
  err = set_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kTmaBM - 1) / kTmaBM);
  kernel<<<grid, kTmaThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), H, S,
      scale, causal);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int S, int D, long long q_sb,
                       long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBlockQ * (D + 1) + (size_t)kBlockK * (D + 1) +
       (size_t)kBlockK * D + (size_t)kBlockQ * (kBlockK + 1));
  // the limit is set once for the largest D this instance takes
  const size_t smem_max = sizeof(float) *
      ((size_t)kBlockQ * (DMAX + 1) + (size_t)kBlockK * (DMAX + 1) +
       (size_t)kBlockK * DMAX + (size_t)kBlockQ * (kBlockK + 1));
  auto kernel = flash_fwd_kernel<DMAX>;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = set_smem_once(kernel, smem_max, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, S, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H, D] with unit stride over D and stride D over H; their
// batch and sequence strides (in elements) are passed. o: contiguous
// [B, S, H, D]. lse: contiguous [B*H, S] f32, or null. dtype: 0 = f32,
// 1 = bf16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int S, int D,
                              long long q_sb, long long q_ss, long long k_sb,
                              long long k_ss, long long v_sb, long long v_ss,
                              float scale, int causal, int dtype,
                              void* stream) {
  if (D < 1 || D > 128 || S < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DL4J_FLASH_ARGS \
  q, k, v, o, lse, B, H, S, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, \
      causal, st
  if (dtype == 0) {
    if (D <= 32) return (int)launch_f32<32>(DL4J_FLASH_ARGS);
    if (D <= 64) return (int)launch_f32<64>(DL4J_FLASH_ARGS);
    return (int)launch_f32<128>(DL4J_FLASH_ARGS);
  }
  if (dtype == 1) {
    // bf16 takes D of 64 or 128 on 16-byte aligned rows (the wrapper pads
    // other shapes)
    if (D == 64)
      return (int)launch_tma<64>(q, k, v, o, lse, B, H, S, q_sb, q_ss, k_sb,
                                 k_ss, v_sb, v_ss, scale, causal, st);
    if (D == 128)
      return (int)launch_tma<128>(q, k, v, o, lse, B, H, S, q_sb, q_ss,
                                  k_sb, k_ss, v_sb, v_ss, scale, causal, st);
    return (int)cudaErrorInvalidValue;
  }
#undef DL4J_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
