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
// kernels skip fully masked tiles and mask only tiles that cross the
// diagonal or the ragged end, whatever the flag says.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 495 TF32, 3.35 TB/s):
//   dkv: max(8*B*H*S^2*D*(1/2 if causal) / rate,
//            (6*B*S*H*D*bytes + 8*B*H*S) / 3.35e12)
//   dq:  max(6*B*H*S^2*D*(1/2 if causal) / rate,
//            (5*B*S*H*D*bytes + 8*B*H*S) / 3.35e12)
//   delta: (2*B*S*H*D*bytes + 4*B*H*S) / 3.35e12
// rate 989e12 for bf16 and 495e12 / 3 for f32 (three TF32 products each).
// At the training shape (B=32, S=512, H=16, D=128, bf16, causal) all three
// are bound by bytes. In f32 at [8, 512, 16, 128] the products bound dK/dV
// (17.2 GFLOP, about 104 us causal) and dQ (12.9 GFLOP, about 78 us).
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
//   - f32 dK/dV: flash_bwd_dkv_3xtf32_kernel, all four products on the
//     tensor cores as 3xTF32 mma.sync (warp_mma.cuh), any D up to 128
//     zero-filled to its bucket: K and V stay in shared memory, Q and dO
//     arrive by cp.async a tile at a time and are split into TF32 hi and
//     lo once for the block, and S^T's and dP^T's C fragments are the A
//     fragments of dV and dK as they stand. See its section below. It
//     issues TF32 mma.sync at about a quarter of the tensor cores' TF32
//     rate, and what holds it there is not the instruction count: halving
//     the split's instructions moved it 2 % (PERF.md).
//   - f32 dQ: flash_bwd_dq_3xtf32_kernel, the f32 dK/dV design mirrored
//     for queries: S, dP and dQ += dS.K on 3xTF32 mma.sync, Q and dO in
//     shared memory for the block's life, K and V streamed by cp.async in
//     key tiles and split into TF32 hi and lo once a tile; S's and dP's C
//     fragments are dQ's A fragments as they stand. See its section below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using hopper::bf16;
using hopper::kLog2e;
using warp_mma::cp_async;
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;
using warp_mma::mma_3xtf32;
using warp_mma::split_tf32;

using hopper::kMaxDevices;
using hopper::set_smem_once;

constexpr int kThreads = 256;  // the delta kernel's block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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

// ------------------------------------------------- f32 dK/dV, 3xTF32 mma.sync
//
// One block of 4 warps per (batch*head, 64-key tile); warp w owns keys
// kw0 = k0 + 16 w .. kw0 + 15, the M rows of every product it issues, so
// the TPU kernel's four products per query tile become
//   S^T = K.Q^T and dP^T = V.dO^T   (M = keys, N = queries, k = D),
//   dV += P^T.dO and dK += dS^T.Q   (M = keys, k = queries, N = D),
// each on the tensor cores as 3xTF32 through mma.sync m16n8k8
// (warp_mma.cuh). K and V stay in shared memory for the whole loop. Q, dO
// and their lse and delta rows arrive a kBQ-query tile at a time by
// cp.async (16-byte chunks where D, the strides and the bases are 4-float
// aligned, single floats otherwise) in one landing stage; after a barrier
// the block splits the tile's Q and dO into TF32 hi and lo arrays once, so
// the four warps and both products that read each value load its halves
// instead of splitting it again at every fragment load; a second barrier
// hands the split tile to the warps and frees the landing stage, and the
// next tile's copy runs while the warps multiply. K and V, private to
// their warp, are split at each fragment load.
// Layouts (g = lane / 4, t = lane % 4):
//   - S^T, dP^T: a float4 at columns 16 kp + 4 t of a row feeds two
//     k-steps (k = t, t + 4 are columns + 0, + 1, then + 2, + 3), in K's
//     and V's A fragments (rows g, g + 8) and Q's and dO's B fragments (row
//     8 n + g) alike, as in the forward's Q.K^T;
//   - their C fragments are the A fragments of dV and dK as they stand:
//     queries 2t and 2t + 1 of an 8-query slice are k = t and t + 4, so the
//     B fragment takes rows 2t and 2t + 1 of dO or Q, a float4 each for four
//     output tiles (tile 4 mm + x holds column 32 mm + 4 c + x at fragment
//     column c). P and dS never leave registers.
// Every tile is [rows][DMAX] with its 16-byte chunks XOR-swizzled by
// swz(row) (the split arrays keep the landing stage's layout): both
// fragment loads of Q and dO (rows 8 n + g at one chunk; rows 2t, 2t + 1
// at chunk 8 mm + g) and K's and V's meet 8 distinct chunks of the 32
// banks in every quarter warp.
// D is zero-filled to its bucket DMAX (32, 64 or 128) and the loops run
// over DMAX. Causal query tiles that end before the block's first key are
// never loaded; a warp skips tiles that end before its first key; masks run
// only on tiles that cross the diagonal or a ragged end, where p is forced
// to 0 (rows past S arrive with lse = delta = 0). p = exp2(s scale log2(e)
// - lse log2(e)), the base-2 form of exp(s scale - lse).
// Shared memory at DMAX = 128 with 16-query tiles: 114,944 bytes, two
// blocks an SM (32-query tiles there would leave one, and ptxas spills);
// 32-query tiles below (kBQ). Registers: dK and dV take 128 of the 248 at
// DMAX = 128.

constexpr int kF32BK = 64;  // keys per block: 4 warps of 16
constexpr int kF32Threads = 128;

template <int DMAX>
struct DkvF32Tiles {
  static constexpr int kBQ = DMAX == 128 ? 16 : 32;  // queries a tile
  static constexpr int kKV = kF32BK * DMAX;  // floats of K (or V)
  static constexpr int kQ = kBQ * DMAX;      // floats of one Q (or dO) tile
  // K, V; the landing stage (Q, dO, lse, delta); the split tile (hi and lo
  // of Q and of dO, lse, delta)
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kKV + (2 * kQ + 2 * kBQ) + (4 * kQ + 2 * kBQ));
};

// The 16-byte chunk c of tile row r lives at chunk c ^ swz(r) (the XOR
// stays inside c's aligned group of 8 chunks).
__device__ __forceinline__ int swz(int r) { return (r & 6) ^ ((r & 1) << 2); }

// Start copying rows [row0, row0 + kRows) of one head (src: its row 0, ss:
// the row stride) into the swizzled tile dst ([kRows][DMAX]): zeros past D
// and past S. 16-byte chunks where `vec4`, single floats otherwise.
template <int kRows, int DMAX>
__device__ __forceinline__ void stage_swizzled(float* dst,
                                               const float* __restrict__ src,
                                               long long ss, int row0, int S,
                                               int D, int vec4) {
  if (vec4) {
    constexpr int kChunks = DMAX / 4;
    for (int i = threadIdx.x; i < kRows * kChunks; i += kF32Threads) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      const int row = row0 + r;
      const int valid = row < S && 4 * c < D ? 4 : 0;  // D is a multiple of 4
      cp_async<4>(dst + r * DMAX + 4 * (c ^ swz(r)),
                  valid ? src + row * ss + 4 * c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DMAX; i += kF32Threads) {
      const int r = i / DMAX;
      const int c = i - r * DMAX;
      const int row = row0 + r;
      const int valid = row < S && c < D ? 1 : 0;
      cp_async<1>(dst + r * DMAX + 4 * ((c >> 2) ^ swz(r)) + (c & 3),
                  valid ? src + row * ss + c : src, valid);
    }
  }
}

// Split a staged tile of kFloats f32 values into TF32 hi and lo arrays at
// the same offsets, so they keep its swizzled layout: one float4 a thread at
// a time.
template <int kFloats>
__device__ __forceinline__ void split_tile(const float* src, uint32_t* hi,
                                           uint32_t* lo) {
  for (int j = threadIdx.x; j < kFloats / 4; j += kF32Threads) {
    const float4 x = *reinterpret_cast<const float4*>(src + 4 * j);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t h[4], l[4];
    split_tf32(xs, h, l);
    *reinterpret_cast<uint4*>(hi + 4 * j) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + 4 * j) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Store a warp's 16 x DMAX accumulator, rows row0 + g and row0 + g + 8, to
// `out` (row stride ss, columns below D); rows at or past S are not stored.
// acc[n][e]: output tile n = 4 mm + x holds column 32 mm + 4 c + x at
// fragment column c, so e = 0, 1 are row g at columns 32 mm + 8 t + x and
// + 4 + x, e = 2, 3 the same of row g + 8.
template <int DMAX>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[DMAX / 8][4],
                                           int row0, int S, int D,
                                           long long ss) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int mm = 0; mm < DMAX / 32; ++mm)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = 32 * mm + 8 * t + 4 * hf;  // columns d .. d + 3
        if (d >= D) continue;
        const int e = 2 * i + hf;
        float* o = out + row * ss + d;
        if (D % 4 == 0) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[4 * mm][e], acc[4 * mm + 1][e],
                          acc[4 * mm + 2][e], acc[4 * mm + 3][e]);
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (d + x < D) o[x] = acc[4 * mm + x][e];
        }
      }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkv_3xtf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int S, int D,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    float scale, int causal, int vec4) {
  using T = DkvF32Tiles<DMAX>;
  constexpr int kBQ = T::kBQ;
  extern __shared__ __align__(16) float dkv_smem[];
  float* Ks = dkv_smem;                // [kF32BK][DMAX]
  float* Vs = Ks + T::kKV;             // [kF32BK][DMAX]
  float* Qs = Vs + T::kKV;             // landing stage: [kBQ][DMAX]
  float* dOs = Qs + T::kQ;             // [kBQ][DMAX]
  float* rows = dOs + T::kQ;           // [lse kBQ, delta kBQ]
  uint32_t* Qh = reinterpret_cast<uint32_t*>(rows + 2 * kBQ);  // split tile
  uint32_t* Ql = Qh + T::kQ;
  uint32_t* dOh = Ql + T::kQ;
  uint32_t* dOl = dOh + T::kQ;
  float* lse_t = reinterpret_cast<float*>(dOl + T::kQ);  // [kBQ]
  float* delta_t = lse_t + kBQ;                           // [kBQ]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // blocks start in the order of blockIdx.y, and under causal masking the
  // first key tiles meet the most query tiles: the heaviest go first
  const int k0 = blockIdx.y * kF32BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 16 * warp;  // this warp's keys: kw0 .. kw0 + 15
  const int sw = swz(g);           // of key rows 16 warp + g (+ 8), and of
                                   // query rows 8 n + g

  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;
  const float* db = dout + b * do_sb + (long long)h * D;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;

  // start copying Q, dO and their lse, delta rows of the query tile at q0
  // into the landing stage; rows past S are zeros
  auto stage_queries = [&](int q0) {
    stage_swizzled<kBQ, DMAX>(Qs, qb, q_ss, q0, S, D, vec4);
    stage_swizzled<kBQ, DMAX>(dOs, db, do_ss, q0, S, D, vec4);
    if (threadIdx.x < 2 * kBQ) {
      const int r = threadIdx.x % kBQ;
      const float* src = threadIdx.x < kBQ ? lse_bh : delta_bh;
      const int valid = q0 + r < S ? 1 : 0;
      cp_async<1>(rows + threadIdx.x, valid ? src + q0 + r : src, valid);
    }
  };

  const int nq = (S + kBQ - 1) / kBQ;
  // query tiles that end before this tile's first key are fully masked
  const int first = causal ? k0 / kBQ : 0;
  stage_swizzled<kF32BK, DMAX>(Ks, kb, k_ss, k0, S, D, vec4);
  stage_swizzled<kF32BK, DMAX>(Vs, vb, v_ss, k0, S, D, vec4);
  stage_queries(first * kBQ);
  cp_async_commit();

  // acc_k, acc_v: keys kw0 + g (+ 8) in store_rows' layout
  float acc_k[DMAX / 8][4], acc_v[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.f;
      acc_v[n][e] = 0.f;
    }
  const float scale_l2 = scale * kLog2e;
  const float* k_lo = Ks + (16 * warp + g) * DMAX;  // key rows g and g + 8
  const float* v_lo = Vs + (16 * warp + g) * DMAX;

  for (int qt = first; qt < nq; ++qt) {
    cp_async_wait<0>();
    __syncthreads();  // tile qt landed; the split tile qt - 1 is consumed
    // split Q and dO once for the block, in the landing stage's layout
    split_tile<T::kQ>(Qs, Qh, Ql);
    split_tile<T::kQ>(dOs, dOh, dOl);
    if (threadIdx.x < 2 * kBQ) lse_t[threadIdx.x] = rows[threadIdx.x];
    __syncthreads();  // the split tile is ready; the landing stage is free
    if (qt + 1 < nq) stage_queries((qt + 1) * kBQ);
    cp_async_commit();
    const int q0 = qt * kBQ;
    // a warp whose keys all lie past S, or (causal) past the tile's last
    // query, would add p = 0 exactly: it skips the tile
    if (kw0 >= S || (causal && kw0 > q0 + kBQ - 1)) continue;

    // s = K.Q^T and dp = V.dO^T on this warp's 16 keys: s[n][e] is key
    // kw0 + g + 8 (e >> 1), query q0 + 8 n + 2 t + (e & 1)
    float s[kBQ / 8][4], dp[kBQ / 8][4];
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const float* a_lo = pass == 0 ? k_lo : v_lo;
      const uint32_t* b_hi = pass == 0 ? Qh : dOh;
      const uint32_t* b_lo = pass == 0 ? Ql : dOl;
#pragma unroll
      for (int kp = 0; kp < DMAX / 16; ++kp) {
        const int c = 4 * ((4 * kp + t) ^ sw);
        const float4 x = *reinterpret_cast<const float4*>(a_lo + c);
        const float4 y = *reinterpret_cast<const float4*>(a_lo + 8 * DMAX + c);
        const float a0[4] = {x.x, y.x, x.y, y.y};
        const float a1[4] = {x.z, y.z, x.w, y.w};
        uint32_t a0h[4], a0l[4], a1h[4], a1l[4];
        split_tf32(a0, a0h, a0l);
        split_tf32(a1, a1h, a1l);
#pragma unroll
        for (int n = 0; n < kBQ / 8; ++n) {
          const uint4 zh =
              *reinterpret_cast<const uint4*>(b_hi + (8 * n + g) * DMAX + c);
          const uint4 zl =
              *reinterpret_cast<const uint4*>(b_lo + (8 * n + g) * DMAX + c);
          const uint32_t b0h[2] = {zh.x, zh.y}, b1h[2] = {zh.z, zh.w};
          const uint32_t b0l[2] = {zl.x, zl.y}, b1l[2] = {zl.z, zl.w};
          if (pass == 0) {
            mma_3xtf32(s[n], a0h, a0l, b0h, b0l);
            mma_3xtf32(s[n], a1h, a1l, b1h, b1l);
          } else {
            mma_3xtf32(dp[n], a0h, a0l, b0h, b0l);
            mma_3xtf32(dp[n], a1h, a1l, b1h, b1l);
          }
        }
      }
    }

    // p = exp(s scale - lse) and ds = p (dp - delta) scale in f32; masks
    // only where the tile crosses the diagonal or a ragged end
    const bool masked = (causal && kw0 + 15 > q0) || q0 + kBQ > S ||
                        kw0 + 16 > S;
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
      const int ql = 8 * n + 2 * t;  // this thread's queries ql, ql + 1
      const float2 ls = *reinterpret_cast<const float2*>(lse_t + ql);
      const float2 dl = *reinterpret_cast<const float2*>(delta_t + ql);
      const float lse_l2[2] = {ls.x * kLog2e, ls.y * kLog2e};
      const float dlt[2] = {dl.x, dl.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_l2, -lse_l2[e & 1]));
        if (masked) {
          const int qpos = q0 + ql + (e & 1), kpos = kw0 + g + 8 * (e >> 1);
          if ((causal && kpos > qpos) || qpos >= S || kpos >= S) p = 0.f;
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dlt[e & 1]) * scale;
      }
    }

    // dV += P^T.dO and dK += dS^T.Q from registers: queries 2t and 2t + 1
    // of slice kn are k = t and t + 4 of the A fragment, so the B fragment
    // takes rows 8 kn + 2 t and + 1 of dO or Q; four values of each row
    // (a 16-byte load of hi, one of lo) feed output tiles 4 mm .. 4 mm + 3
#pragma unroll
    for (int kn = 0; kn < kBQ / 8; ++kn) {
      const float pa[4] = {s[kn][0], s[kn][2], s[kn][1], s[kn][3]};
      const float da[4] = {dp[kn][0], dp[kn][2], dp[kn][1], dp[kn][3]};
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_tf32(pa, ph, pl);
      split_tf32(da, dh, dl);
      const int r0 = 8 * kn + 2 * t;
      const int sw0 = swz(r0), sw1 = swz(r0 + 1);
#pragma unroll
      for (int mm = 0; mm < DMAX / 32; ++mm) {
        const int c0 = 4 * ((8 * mm + g) ^ sw0);
        const int c1 = 4 * ((8 * mm + g) ^ sw1);
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          const uint32_t* b_hi = (pass == 0 ? dOh : Qh) + r0 * DMAX;
          const uint32_t* b_lo = (pass == 0 ? dOl : Ql) + r0 * DMAX;
          const uint4 h0 = *reinterpret_cast<const uint4*>(b_hi + c0);
          const uint4 h1 = *reinterpret_cast<const uint4*>(b_hi + DMAX + c1);
          const uint4 l0 = *reinterpret_cast<const uint4*>(b_lo + c0);
          const uint4 l1 = *reinterpret_cast<const uint4*>(b_lo + DMAX + c1);
          const uint32_t bhx[4][2] = {{h0.x, h1.x}, {h0.y, h1.y},
                                      {h0.z, h1.z}, {h0.w, h1.w}};
          const uint32_t blx[4][2] = {{l0.x, l1.x}, {l0.y, l1.y},
                                      {l0.z, l1.z}, {l0.w, l1.w}};
#pragma unroll
          for (int xx = 0; xx < 4; ++xx) {
            if (pass == 0)
              mma_3xtf32(acc_v[4 * mm + xx], ph, pl, bhx[xx], blx[xx]);
            else
              mma_3xtf32(acc_k[4 * mm + xx], dh, dl, bhx[xx], blx[xx]);
          }
        }
      }
    }
  }

  // dK and dV; keys past S are never stored
  const long long ss = (long long)H * D;  // outputs: contiguous [B, S, H, D]
  const long long out0 = (long long)b * S * ss + (long long)h * D;
  store_rows<DMAX>(dk + out0, acc_k, kw0, S, D, ss);
  store_rows<DMAX>(dv + out0, acc_v, kw0, S, D, ss);
}

// ---------------------------------------------------- f32 dQ, 3xTF32 mma.sync
//
// The dK/dV body mirrored for queries. One block of 4 warps per
// (batch*head, 64-query tile); warp w owns queries qw0 = q0 + 16 w ..
// qw0 + 15, the M rows of the three products it issues per key tile:
//   S = Q.K^T and dP = dO.V^T   (M = queries, N = keys, k = D),
//   dQ += dS.K                  (M = queries, k = keys, N = D),
// each on the tensor cores as 3xTF32 through mma.sync m16n8k8
// (warp_mma.cuh). Q and dO are staged once by cp.async and stay in shared
// memory as f32 for the whole loop; each warp splits its rows at each
// fragment load, as the forward does with Q (their hi and lo arrays take
// 128 KB at DMAX = 128, leave one block an SM and ran 1.7x slower:
// PERF.md). K and V arrive a
// kBK-key tile at a time in one landing stage; after a barrier the block
// splits them into TF32 hi and lo arrays once, so the four warps, and for K
// both products, load each value's halves; a second barrier hands the split
// tile to the warps and frees the landing stage, and the next tile's copy
// runs while the warps multiply.
// Layouts (g = lane / 4, t = lane % 4), the dK/dV body's with the roles of
// queries and keys swapped:
//   - S, dP: a float4 at columns 16 kp + 4 t of a row feeds two k-steps, in
//     Q's and dO's A fragments (rows g, g + 8) and K's and V's B fragments
//     (row 8 n + g) alike, as in the forward's Q.K^T;
//   - their C fragments are the A fragments of dQ += dS.K as they stand:
//     keys 2t and 2t + 1 of an 8-key slice are k = t and t + 4, so the B
//     fragment takes rows 2t and 2t + 1 of K, a float4 each (chunk
//     8 mm + g) for four output tiles. P and dS never leave registers.
// K is read in both layouts; the XOR swizzle of 16-byte chunks (swz) keeps
// both loads, and the A loads of Q and dO, free of bank conflicts.
// D is zero-filled to its bucket DMAX and the loops run over DMAX. The
// heaviest causal query tiles launch first; key tiles past the block's last
// query are never loaded (the forward's bound); a warp skips tiles whose
// first key lies past its last query; masks run only on tiles that cross
// the diagonal or the ragged end of the keys. Rows past S arrive with
// q = dO = lse = delta = 0 (finite p, ds = 0) and are never stored, so they
// need no mask. p = exp2(s scale log2(e) - lse log2(e)).
// Shared memory at DMAX = 128 with 16-key tiles: 114,688 bytes, two blocks
// an SM (32-key tiles there leave one and ran 1.25x slower); 32-key tiles
// below (kBK). Registers: dQ takes 64 of the 180 at DMAX = 128; a zeroed
// accumulator a tile, added into dQ in f32, cut the error against the plain
// version by up to 1.65x, cost 5 % and spilled at DMAX = 64 (PERF.md).

constexpr int kF32BQ = 64;  // queries per dQ block: 4 warps of 16

template <int DMAX>
struct DqF32Tiles {
  static constexpr int kBK = DMAX == 128 ? 16 : 32;  // keys a tile
  static constexpr int kQ = kF32BQ * DMAX;   // floats of Q (or dO)
  static constexpr int kKV = kBK * DMAX;     // floats of one K (or V) tile
  // Q, dO; the landing stage (K, V); the split tile (hi and lo of K and V)
  static constexpr size_t kBytes = sizeof(float) * (2 * kQ + 6 * kKV);
};

template <int DMAX>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_3xtf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int S, int D, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, long long do_sb, long long do_ss, float scale,
    int causal, int vec4) {
  using T = DqF32Tiles<DMAX>;
  constexpr int kBK = T::kBK;
  extern __shared__ __align__(16) float dq_smem[];
  float* Qs = dq_smem;       // [kF32BQ][DMAX]
  float* dOs = Qs + T::kQ;   // [kF32BQ][DMAX]
  float* Ks = dOs + T::kQ;   // landing stage: [kBK][DMAX]
  float* Vs = Ks + T::kKV;   // [kBK][DMAX]
  uint32_t* Kh = reinterpret_cast<uint32_t*>(Vs + T::kKV);  // split tile
  uint32_t* Kl = Kh + T::kKV;
  uint32_t* Vh = Kl + T::kKV;
  uint32_t* Vl = Vh + T::kKV;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // the causal work of a query tile grows with its index, and blocks start
  // in the order of blockIdx.y: the heaviest tiles go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qw0 = q0 + 16 * warp;  // this warp's queries: qw0 .. qw0 + 15
  const int sw = swz(g);           // of query rows 16 warp + g (+ 8), and of
                                   // key rows 8 n + g

  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;
  const float* db = dout + b * do_sb + (long long)h * D;

  int nk = (S + kBK - 1) / kBK;
  if (causal) {
    // the forward's bound: key tiles past this tile's last query add nothing
    const int needed = (q0 + kF32BQ + kBK - 1) / kBK;
    nk = nk < needed ? nk : needed;
  }
  stage_swizzled<kF32BQ, DMAX>(Qs, qb, q_ss, q0, S, D, vec4);
  stage_swizzled<kF32BQ, DMAX>(dOs, db, do_ss, q0, S, D, vec4);
  stage_swizzled<kBK, DMAX>(Ks, kb, k_ss, 0, S, D, vec4);
  stage_swizzled<kBK, DMAX>(Vs, vb, v_ss, 0, S, D, vec4);
  cp_async_commit();

  // lse (times log2(e)) and delta of rows qw0 + g and qw0 + g + 8; 0 past S
  float lse_l2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw0 + g + 8 * i;
    const bool in = row < S;
    lse_l2[i] = in ? __ldg(lse + (long long)bh * S + row) * kLog2e : 0.f;
    dlt[i] = in ? __ldg(delta + (long long)bh * S + row) : 0.f;
  }

  float acc[DMAX / 8][4];  // in store_rows' layout
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_l2 = scale * kLog2e;
  const float* q_lo = Qs + (16 * warp + g) * DMAX;  // query rows g and g + 8
  const float* do_lo = dOs + (16 * warp + g) * DMAX;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; the split tile j - 1 is consumed
    split_tile<T::kKV>(Ks, Kh, Kl);
    split_tile<T::kKV>(Vs, Vh, Vl);
    __syncthreads();  // the split tile is ready; the landing stage is free
    if (j + 1 < nk) {
      stage_swizzled<kBK, DMAX>(Ks, kb, k_ss, (j + 1) * kBK, S, D, vec4);
      stage_swizzled<kBK, DMAX>(Vs, vb, v_ss, (j + 1) * kBK, S, D, vec4);
    }
    cp_async_commit();
    const int k0 = j * kBK;
    // a warp whose queries all lie past S, or (causal) before the tile's
    // first key, would add nothing to a stored row: it skips the tile
    if (qw0 >= S || (causal && k0 > qw0 + 15)) continue;

    // s = Q.K^T and dp = dO.V^T on this warp's 16 queries: s[n][e] is query
    // qw0 + g + 8 (e >> 1), key k0 + 8 n + 2 t + (e & 1)
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const float* a_lo = pass == 0 ? q_lo : do_lo;
      const uint32_t* b_hi = pass == 0 ? Kh : Vh;
      const uint32_t* b_lo = pass == 0 ? Kl : Vl;
#pragma unroll
      for (int kp = 0; kp < DMAX / 16; ++kp) {
        const int c = 4 * ((4 * kp + t) ^ sw);
        const float4 x = *reinterpret_cast<const float4*>(a_lo + c);
        const float4 y = *reinterpret_cast<const float4*>(a_lo + 8 * DMAX + c);
        const float a0[4] = {x.x, y.x, x.y, y.y};
        const float a1[4] = {x.z, y.z, x.w, y.w};
        uint32_t a0h[4], a0l[4], a1h[4], a1l[4];
        split_tf32(a0, a0h, a0l);
        split_tf32(a1, a1h, a1l);
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n) {
          const uint4 zh =
              *reinterpret_cast<const uint4*>(b_hi + (8 * n + g) * DMAX + c);
          const uint4 zl =
              *reinterpret_cast<const uint4*>(b_lo + (8 * n + g) * DMAX + c);
          const uint32_t b0h[2] = {zh.x, zh.y}, b1h[2] = {zh.z, zh.w};
          const uint32_t b0l[2] = {zl.x, zl.y}, b1l[2] = {zl.z, zl.w};
          if (pass == 0) {
            mma_3xtf32(s[n], a0h, a0l, b0h, b0l);
            mma_3xtf32(s[n], a1h, a1l, b1h, b1l);
          } else {
            mma_3xtf32(dp[n], a0h, a0l, b0h, b0l);
            mma_3xtf32(dp[n], a1h, a1l, b1h, b1l);
          }
        }
      }
    }

    // ds = p (dp - delta) scale with p = exp(s scale - lse), in f32; masks
    // only where the tile crosses the diagonal or the ragged end of the keys
    const bool masked = (causal && k0 + kBK - 1 > qw0) || k0 + kBK > S;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_l2, -lse_l2[e >> 1]));
        if (masked) {
          const int qpos = qw0 + g + 8 * (e >> 1);
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          if ((causal && kpos > qpos) || kpos >= S) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - dlt[e >> 1]) * scale;
      }

    // dQ += dS.K from registers: keys 2t and 2t + 1 of slice kn are k = t
    // and t + 4 of the A fragment, so the B fragment takes rows 8 kn + 2 t
    // and + 1 of K; four values of each row (a 16-byte load of hi, one of
    // lo) feed output tiles 4 mm .. 4 mm + 3
#pragma unroll
    for (int kn = 0; kn < kBK / 8; ++kn) {
      const float da[4] = {s[kn][0], s[kn][2], s[kn][1], s[kn][3]};
      uint32_t dh[4], dl[4];
      split_tf32(da, dh, dl);
      const int r0 = 8 * kn + 2 * t;
      const int sw0 = swz(r0), sw1 = swz(r0 + 1);
      const uint32_t* h_row = Kh + r0 * DMAX;
      const uint32_t* l_row = Kl + r0 * DMAX;
#pragma unroll
      for (int mm = 0; mm < DMAX / 32; ++mm) {
        const int c0 = 4 * ((8 * mm + g) ^ sw0);
        const int c1 = 4 * ((8 * mm + g) ^ sw1);
        const uint4 h0 = *reinterpret_cast<const uint4*>(h_row + c0);
        const uint4 h1 = *reinterpret_cast<const uint4*>(h_row + DMAX + c1);
        const uint4 l0 = *reinterpret_cast<const uint4*>(l_row + c0);
        const uint4 l1 = *reinterpret_cast<const uint4*>(l_row + DMAX + c1);
        const uint32_t bhx[4][2] = {{h0.x, h1.x}, {h0.y, h1.y},
                                    {h0.z, h1.z}, {h0.w, h1.w}};
        const uint32_t blx[4][2] = {{l0.x, l1.x}, {l0.y, l1.y},
                                    {l0.z, l1.z}, {l0.w, l1.w}};
#pragma unroll
        for (int xx = 0; xx < 4; ++xx)
          mma_3xtf32(acc[4 * mm + xx], dh, dl, bhx[xx], blx[xx]);
      }
    }
  }

  // dQ; queries past S are never stored
  const long long ss = (long long)H * D;  // output: contiguous [B, S, H, D]
  store_rows<DMAX>(dq + (long long)b * S * ss + (long long)h * D, acc, qw0,
                   S, D, ss);
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

// whether the f32 bodies may copy q, k, v and dO in 16-byte chunks
int f32_vec4(const Args& a) {
  using warp_mma::rows_vec4;
  return a.D % 4 == 0 && rows_vec4(a.q, a.q_sb, a.q_ss) &&
         rows_vec4(a.k, a.k_sb, a.k_ss) && rows_vec4(a.v, a.v_sb, a.v_ss) &&
         rows_vec4(a.dout, a.do_sb, a.do_ss);
}

template <int DMAX>
cudaError_t launch_dkv_f32(const Args& a) {
  auto kernel = flash_bwd_dkv_3xtf32_kernel<DMAX>;
  constexpr size_t smem = DkvF32Tiles<DMAX>::kBytes;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = set_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.S + kF32BK - 1) / kF32BK);
  kernel<<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.H, a.S, a.D, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb,
      a.do_ss, a.scale, a.causal, f32_vec4(a));
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq_f32(const Args& a) {
  auto kernel = flash_bwd_dq_3xtf32_kernel<DMAX>;
  constexpr size_t smem = DqF32Tiles<DMAX>::kBytes;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = set_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.S + kF32BQ - 1) / kF32BQ);
  kernel<<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.S, a.D, a.q_sb,
      a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.scale,
      a.causal, f32_vec4(a));
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

// dispatch on the input type (0 = f32: the 3xTF32 mma.sync bodies, 1 = bf16:
// the TMA + wgmma bodies) and the head_dim bucket
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
