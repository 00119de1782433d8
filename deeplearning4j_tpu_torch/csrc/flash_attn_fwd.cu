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
// f32 products go through the tensor cores as 3xTF32 (warp_mma.cuh): about
// 2^-20 a term against the TPU's f32 products, within the 1e-4 that f32
// attention is held to; a single TF32 product (2^-11) would miss it.
// Keys past a ragged end of the sequence are masked in the kernel with -inf
// (p is exactly 0 there), so any S runs here: the TPU path fell back to a
// jax-level blockwise loop for ragged S, this one has no fallback.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 495 TF32, 3.35 TB/s HBM):
//   max(4*B*H*S^2*D*(1/2 if causal) / rate, 4*B*S*H*D*bytes / 3.35e12) s,
// rate 989e12 for bf16 and 495e12 / 3 for f32 (three TF32 products each).
// At the serving shape (B=8, S=512, H=16, D=128, bf16, causal) the byte
// term is larger: about 67 MB, about 20 us. In f32 at the same shape the
// products bound it: 8.6 GFLOP, about 52 us causal.
//
// Design. The TPU grid's sequential kv axis becomes a loop over key tiles
// inside a block; causal tiles past the diagonal are never visited.
//   - bf16 (the serving and training paths): flash_fwd_tma_kernel, one
//     block of three warpgroups per (batch*head, 128-query tile), D of 64
//     or 128 (the wrapper zero-pads other head dims). Warpgroup 2 is the
//     producer: `setmaxnreg` gives its registers to the consumers, and one
//     of its threads loads Q once and streams K and V tiles by TMA
//     (rank-4 tensor maps over the strided [B, S, H, D] views, [rows][64]
//     boxes, 128-byte swizzle, zeros past S) into a two-stage ring with
//     full / empty mbarriers, so loads overlap the products. Warpgroups 0
//     and 1 each own 64 query rows: S = (q*scale).K^T is wgmma m64nBNk16
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
//   - f32: flash_fwd_3xtf32_kernel, any D up to 128 (zero-filled to the
//     width of its bucket, 32, 64 or 128), on the tensor cores through
//     mma.sync m16n8k8 TF32 with each operand split into hi + lo
//     (3xTF32). One block of 4 warps per (batch*head, 64-query tile),
//     each warp 16 query rows; K and V tiles (by default 64 keys at D = 64,
//     else 32: at D = 128 for two blocks an SM, at D = 32 because ptxas
//     spills with 64) stream through a two-stage cp.async ring (16-byte chunks
//     where D, the strides and the bases are 4-float aligned, as the
//     fused qkv views are; single floats otherwise) behind one barrier a
//     tile, so the copy of tile j + 1 runs while tile j is multiplied; Q
//     stays in shared memory and is scaled and split at each fragment
//     load (in registers its hi and lo would take 128 registers at
//     D = 128 beside the 64 of the accumulator). The order of k inside a k-step is free, so one float4 of a Q or K row
//     feeds two k-steps, and S's accumulator fragment is P.V's A fragment
//     as it stands (keys 2t, 2t + 1 of an 8-key slice are k = t, t + 4;
//     V's B fragment takes the same two rows, one float2 each for two
//     output tiles): P never leaves registers. The online softmax runs on
//     the fragments with quad shuffles; masks only on diagonal or ragged
//     tiles, a warp skips key tiles past its last row, and the heaviest
//     causal query tiles launch first. What bounds it on this card is the
//     instruction rate: per TF32 product about three other instructions
//     (the splits of K and V, fragment loads, the softmax), PERF.md.

// Tile variants. The key tile BN is a template parameter of both bodies,
// built at two values where shared memory allows (bf16: 128 and 64 at D of
// 64 and 128; f32: 64 and 32 at D = 64, 32 and 64 at D = 128; D = 32 at 32
// alone). The C entry point takes block_k (0: the default above), and a
// tuned table (`attention.block_fwd`, optimize/tunables.py) names the
// variant through the wrapper in nd/kernels.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using hopper::kMaxDevices;
using hopper::set_smem_once;

constexpr float kNegBig = -1e30f;

// ---------------------------------------------- f32, 3xTF32 on mma.sync

using hopper::kLog2e;
using warp_mma::cp_async;
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;
using warp_mma::mma_3xtf32;
using warp_mma::split_tf32;

constexpr int kF32BM = 64;  // queries per block: 4 warps of 16 rows
constexpr int kF32Threads = 128;

// The f32 body's shared memory for head dims up to DMAX: the block's Q tile
// and a two-stage ring of K and V tiles of BN keys (107,520 bytes at
// DMAX = 128 and BN = 32: two blocks an SM; 178,176 at BN = 64: one). The row strides make the fragment loads
// conflict-free: a quarter warp's float4 loads of Q or K (2 rows x 4 column
// quads) meet 8 distinct 16-byte bank groups when the stride is 16 mod 32
// floats; a half warp's float2 loads of V (4 rows x 4 column pairs) meet 16
// distinct 8-byte bank pairs when it is 4 mod 16.
template <int DMAX, int BN>
struct F32Tiles {
  static constexpr int kBN = BN;  // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kLdQK = DMAX + 16;
  static constexpr int kLdV = DMAX + 4;
  static constexpr int kQ = kF32BM * kLdQK;  // floats
  static constexpr int kK = kBN * kLdQK;
  static constexpr int kV = kBN * kLdV;
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kStages * (kK + kV));
};

// Start copying rows [row0, row0 + kRows) of one head (src: its row 0, ss:
// the row stride) into dst ([kRows][kLd]), columns [0, DMAX): zeros past D
// and past S. 16-byte chunks where `vec4` (D, the strides and the base
// 4-float aligned), single floats otherwise.
template <int kRows, int DMAX, int kLd>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           long long ss, int row0, int S,
                                           int D, int vec4) {
  if (vec4) {
    constexpr int kChunks = DMAX / 4;
    for (int i = threadIdx.x; i < kRows * kChunks; i += kF32Threads) {
      const int r = i / kChunks;
      const int c = 4 * (i - r * kChunks);
      const int row = row0 + r;
      const int valid = row < S && c < D ? 4 : 0;  // D is a multiple of 4
      cp_async<4>(dst + r * kLd + c, valid ? src + row * ss + c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DMAX; i += kF32Threads) {
      const int r = i / DMAX;
      const int c = i - r * DMAX;
      const int row = row0 + r;
      const int valid = row < S && c < D ? 1 : 0;
      cp_async<1>(dst + r * kLd + c, valid ? src + row * ss + c : src, valid);
    }
  }
}

template <int DMAX, int BN>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_3xtf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int H, int S, int D,
                        long long q_sb, long long q_ss, long long k_sb,
                        long long k_ss, long long v_sb, long long v_ss,
                        float scale, int causal, int vec4) {
  using T = F32Tiles<DMAX, BN>;
  constexpr int kBN = T::kBN;
  constexpr int kLdQK = T::kLdQK;
  constexpr int kLdV = T::kLdV;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [kF32BM][kLdQK]
  float* Ks = Qs + T::kQ;               // [stage][kBN][kLdQK]
  float* Vs = Ks + T::kStages * T::kK;  // [stage][kBN][kLdV]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // the causal work of a query tile grows with its index, and blocks start
  // in the order of blockIdx.y: the heaviest tiles go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + 16 * warp;  // this warp's rows: w0 .. w0 + 15

  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;

  int nk = (S + kBN - 1) / kBN;
  if (causal) {
    // tiles whose first key lies past this tile's last query add nothing
    const int needed = (q0 + kF32BM + kBN - 1) / kBN;
    nk = nk < needed ? nk : needed;
  }

  stage_rows<kF32BM, DMAX, kLdQK>(Qs, qb, q_ss, q0, S, D, vec4);
  stage_rows<kBN, DMAX, kLdQK>(Ks, kb, k_ss, 0, S, D, vec4);
  stage_rows<kBN, DMAX, kLdV>(Vs, vb, v_ss, 0, S, D, vec4);
  cp_async_commit();

  // acc[n][e]: output tile n = 2 mm + x holds column 16 mm + 2 c + x at
  // fragment column c, so e = 0, 1 are row g at columns 16 mm + 4 t + x and
  // + 2 + x, e = 2, 3 the same of row g + 8
  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegBig, kNegBig};  // rows w0 + g and w0 + g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums

  const float* q_lo = Qs + (16 * warp + g) * kLdQK + 4 * t;
  const float* q_hi = q_lo + 8 * kLdQK;
  for (int j = 0; j < nk; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed for every thread; j - 1's stage free
    if (j + 1 < nk) {
      const int st = (j + 1) % T::kStages;
      stage_rows<kBN, DMAX, kLdQK>(Ks + st * T::kK, kb, k_ss, (j + 1) * kBN,
                                   S, D, vec4);
      stage_rows<kBN, DMAX, kLdV>(Vs + st * T::kV, vb, v_ss, (j + 1) * kBN,
                                  S, D, vec4);
    }
    cp_async_commit();
    const int k0 = j * kBN;
    // a warp whose rows all lie past S, or (causal) before the tile's first
    // key, would add p = 0 exactly: it skips the tile
    if (w0 >= S || (causal && k0 > w0 + 15)) continue;
    const float* Kt = Ks + (j % T::kStages) * T::kK;
    const float* Vt = Vs + (j % T::kStages) * T::kV;

    // s = (q * scale) . k^T. A float4 at column 16 kp + 4 t of a row feeds
    // two k-steps: k = t, t + 4 are columns + 0, + 1 in the first and
    // + 2, + 3 in the second, in Q's A fragments and K's B fragments alike
    float s[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < DMAX / 16; ++kp) {
      const float4 x = *reinterpret_cast<const float4*>(q_lo + 16 * kp);
      const float4 y = *reinterpret_cast<const float4*>(q_hi + 16 * kp);
      // q * scale in f32, as the TPU kernel scales q in its input type
      const float a0[4] = {x.x * scale, y.x * scale, x.y * scale, y.y * scale};
      const float a1[4] = {x.z * scale, y.z * scale, x.w * scale, y.w * scale};
      uint32_t a0h[4], a0l[4], a1h[4], a1l[4];
      split_tf32(a0, a0h, a0l);
      split_tf32(a1, a1h, a1l);
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const float4 z = *reinterpret_cast<const float4*>(
            Kt + (8 * n + g) * kLdQK + 16 * kp + 4 * t);
        const float b0[2] = {z.x, z.y}, b1[2] = {z.z, z.w};
        uint32_t b0h[2], b0l[2], b1h[2], b1l[2];
        split_tf32(b0, b0h, b0l);
        split_tf32(b1, b1h, b1l);
        mma_3xtf32(s[n], a0h, a0l, b0h, b0l);
        mma_3xtf32(s[n], a1h, a1l, b1h, b1l);
      }
    }

    // masks only where a tile crosses the diagonal or the ragged end:
    // elsewhere they select every score unchanged. s[n][e] is row
    // w0 + g + 8 (e >> 1), key k0 + 8 n + 2 t + (e & 1)
    if (k0 + kBN > S || (causal && k0 + kBN - 1 > w0)) {
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          if (kpos >= S) {
            s[n][e] = -INFINITY;
          } else if (causal && kpos > w0 + g + 8 * (e >> 1)) {
            s[n][e] = kNegBig;
          }
        }
    }

    // online softmax on the fragments, in base 2: the quad of a row's four
    // threads shares the max
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], kLog2e, -ms[e >> 1]));
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // acc += p . v with p from registers: the keys 8 kn + 2 t and
    // 8 kn + 2 t + 1 that the S fragment holds are k = t and k = t + 4 of
    // the A fragment, so V's B fragment takes the same two rows; a float2
    // of each row feeds output tiles 2 mm and 2 mm + 1
#pragma unroll
    for (int kn = 0; kn < kBN / 8; ++kn) {
      const float pa[4] = {s[kn][0], s[kn][2], s[kn][1], s[kn][3]};
      uint32_t ph[4], pl[4];
      split_tf32(pa, ph, pl);
      const float* v0 = Vt + (8 * kn + 2 * t) * kLdV + 2 * g;
#pragma unroll
      for (int mm = 0; mm < DMAX / 16; ++mm) {
        const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * mm);
        const float2 x1 =
            *reinterpret_cast<const float2*>(v0 + kLdV + 16 * mm);
        const float b0[2] = {x0.x, x1.x}, b1[2] = {x0.y, x1.y};
        uint32_t b0h[2], b0l[2], b1h[2], b1l[2];
        split_tf32(b0, b0h, b0l);
        split_tf32(b1, b1h, b1l);
        mma_3xtf32(acc[2 * mm], ph, pl, b0h, b0l);
        mma_3xtf32(acc[2 * mm + 1], ph, pl, b1h, b1l);
      }
    }
  }

  const long long o_ss = (long long)H * D;
  float* ob = o + (long long)b * S * o_ss + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float lc = fmaxf(l[i], 1e-30f);
    const int row = w0 + g + 8 * i;
    if (row >= S) continue;
    float* orow = ob + row * o_ss;
#pragma unroll
    for (int mm = 0; mm < DMAX / 16; ++mm) {
      const int d = 16 * mm + 4 * t;  // columns d .. d + 3
      if (d >= D) break;
      const float out[4] = {acc[2 * mm][2 * i] / lc,
                            acc[2 * mm + 1][2 * i] / lc,
                            acc[2 * mm][2 * i + 1] / lc,
                            acc[2 * mm + 1][2 * i + 1] / lc};
      if (D % 4 == 0) {
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) orow[d + e] = out[e];
      }
    }
    if (lse != nullptr && t == 0)
      lse[(long long)bh * S + row] = m[i] + logf(lc);
  }
}

// -------------------------------------------------------- bf16, TMA + wgmma

using hopper::bf16;

constexpr int kTmaBM = 128;       // queries per block: 2 consumer warpgroups
constexpr int kTmaStages = 2;     // depth of the K/V ring
constexpr int kTmaThreads = 384;  // warpgroups 0, 1 consume; 2 produces

// Every box is [rows][64] bf16 with the 128-byte swizzle; every array size
// is a multiple of 1024 bytes, so each box stays 1024-byte aligned.
template <int D, int BN>
struct FwdSmem {
  bf16 q[D / 64][kTmaBM * 64];
  bf16 k[kTmaStages][D / 64][BN * 64];
  bf16 v[kTmaStages][D / 64][BN * 64];
  uint64_t q_full;
  uint64_t k_full[kTmaStages], v_full[kTmaStages], empty[kTmaStages];
};

union Pack8 {  // 8 bf16 = one 16-byte load or store
  uint4 u;
  bf16 h[8];
};

// BN (keys a tile, 128 or 64) is the N of the S = Q.K^T wgmma, the k-steps
// of P.V and the rows of each K and V box.
template <int D, int BN>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     bf16* __restrict__ o, float* __restrict__ lse, int H,
                     int S, float scale, int causal) {
  using namespace hopper;
  constexpr int kBoxes = D / 64;
  constexpr int kTmaBN = BN;
  constexpr uint32_t kQBox = kTmaBM * 128, kKBox = kTmaBN * 128;  // bytes
  extern __shared__ char smem_raw[];
  FwdSmem<D, BN>& sm =
      *reinterpret_cast<FwdSmem<D, BN>*>(align_1024(smem_raw));

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
        if constexpr (BN == 128)
          wgmma_ss_n128(s, desc_at(qd, (kk / 4) * kQBox + off),
                        desc_at(kd, (kk / 4) * kKBox + off), kk);
        else
          wgmma_ss_n64(s, desc_at(qd, (kk / 4) * kQBox + off),
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

template <int D, int BN>
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
    err = heads_map(&mk, k, B, S, H, D, k_ss, k_sb, BN);
  if (err == cudaSuccess)
    err = heads_map(&mv, v, B, S, H, D, v_ss, v_sb, BN);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(FwdSmem<D, BN>) + 1024;  // + alignment slack
  auto kernel = flash_fwd_tma_kernel<D, BN>;
  static std::atomic<bool> smem_set[kMaxDevices];
  err = set_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kTmaBM - 1) / kTmaBM);
  kernel<<<grid, kTmaThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), H, S,
      scale, causal);
  return cudaGetLastError();
}

template <int DMAX, int BN>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int S, int D, long long q_sb,
                       long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, float scale, int causal,
                       cudaStream_t stream) {
  using warp_mma::rows_vec4;
  const int vec4 = D % 4 == 0 && rows_vec4(q, q_sb, q_ss) &&
                   rows_vec4(k, k_sb, k_ss) && rows_vec4(v, v_sb, v_ss);
  const size_t smem = F32Tiles<DMAX, BN>::kBytes;
  auto kernel = flash_fwd_3xtf32_kernel<DMAX, BN>;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = set_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kF32BM - 1) / kF32BM);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, S, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
      scale, causal, vec4);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H, D] with unit stride over D and stride D over H; their
// batch and sequence strides (in elements) are passed. o: contiguous
// [B, S, H, D]. lse: contiguous [B*H, S] f32, or null. dtype: 0 = f32,
// 1 = bf16. block_k: keys a tile, 0 for the body's default; the bodies are
// built at bf16 {128 (default), 64}, f32 D <= 32 {32}, D <= 64 {64
// (default), 32}, D <= 128 {32 (default), 64}, and another value is
// refused. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int S, int D,
                              long long q_sb, long long q_ss, long long k_sb,
                              long long k_ss, long long v_sb, long long v_ss,
                              float scale, int causal, int dtype, int block_k,
                              void* stream) {
  if (D < 1 || D > 128 || S < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DL4J_FLASH_ARGS \
  q, k, v, o, lse, B, H, S, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, \
      causal, st
  if (dtype == 0) {
    if (D <= 32) {
      if (block_k == 0 || block_k == 32)
        return (int)launch_f32<32, 32>(DL4J_FLASH_ARGS);
    } else if (D <= 64) {
      if (block_k == 0 || block_k == 64)
        return (int)launch_f32<64, 64>(DL4J_FLASH_ARGS);
      if (block_k == 32) return (int)launch_f32<64, 32>(DL4J_FLASH_ARGS);
    } else {
      if (block_k == 0 || block_k == 32)
        return (int)launch_f32<128, 32>(DL4J_FLASH_ARGS);
      if (block_k == 64) return (int)launch_f32<128, 64>(DL4J_FLASH_ARGS);
    }
    return (int)cudaErrorInvalidValue;
  }
#define DL4J_TMA_ARGS \
  q, k, v, o, lse, B, H, S, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, \
      causal, st
  if (dtype == 1) {
    // bf16 takes D of 64 or 128 on 16-byte aligned rows (the wrapper pads
    // other shapes)
    const int bn = block_k == 0 ? 128 : block_k;
    if (D == 64 && bn == 128) return (int)launch_tma<64, 128>(DL4J_TMA_ARGS);
    if (D == 64 && bn == 64) return (int)launch_tma<64, 64>(DL4J_TMA_ARGS);
    if (D == 128 && bn == 128)
      return (int)launch_tma<128, 128>(DL4J_TMA_ARGS);
    if (D == 128 && bn == 64) return (int)launch_tma<128, 64>(DL4J_TMA_ARGS);
    return (int)cudaErrorInvalidValue;
  }
#undef DL4J_TMA_ARGS
#undef DL4J_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
