// Fused LSTM cell for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_lstm_cell_kernel` / `_fused_lstm_impl` in
// deeplearning4j_tpu/nd/pallas_kernels.py (:529-570): one cell update
//   z  = x.Wx + h.Wh + b          (f32 sums; gate order [i | f | o | g])
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
// with both products, the bias and the gates in one kernel. z never goes to
// device memory, as the TPU kernel kept it in VMEM. h' and c' are rounded
// once, to h's and c's type; h' is taken from the unrounded c'.
//
// Numerics: the two products are summed apart and then added, (x.Wx +
// h.Wh) + b, as the TPU kernel's two dots are. f32 operands go through
// scalar f32 FMAs (the tensor cores would round them to tf32, which misses
// the 1e-5 tolerance of the JAX package's own test); bf16 operands through
// mma.sync m16n8k16 with f32 sums. sigmoid is 1 / (1 + exp(-x)), with the
// full-precision expf and tanhf, and c' is f*c + i*g without contraction.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 989 bf16,
// 3.35 TB/s HBM), for x [B, I], h and c [B, H], W [(I + H), 4H]:
//   operations 2*B*(I + H)*4H, bytes (B*I + 2*B*H + (I + H)*4H + 4H) read
//   plus 2*B*H written, times the element size.
// At the bench shape (f32, B = 256, I = H = 256) that is 2.68e8 FLOP, about
// 4.0 us at 67 TFLOP/s, against about 3.4 MB, about 1.0 us: bound by
// operations. A 64-step, 4-layer forward launches this kernel 256 times, so
// it cannot take less than about 1 ms.
//
// Design. One block owns a tile of batch rows and a tile of hidden columns
// j, and computes the four gate columns j, H + j, 2H + j, 3H + j of z for
// it, so every thread ends with all four gates of its (row, column) pairs
// in registers and applies the cell there. The K loop runs over the I
// inputs (x, Wx) and then the H recurrent inputs (h, Wh) through shared
// tiles of x or h and of the four column slices of Wx or Wh. Ragged B, I
// and H are zero-filled on load and masked on store: there is no fallback.
// Operands may be row-strided views (a time step of [B, T, I], the two row
// blocks of one fused W); the last dimension must have unit stride.
//   - f32: lstm_cell_f32_kernel. 8 warps; a lane owns one hidden column, a
//     warp two batch rows, so a block is 16 rows x 32 columns x 4 gates. At
//     the bench shape that is 16 x 8 = 128 blocks of 256 threads for the
//     132 SMs: one wave. x is staged transposed so that one 8-byte load
//     brings a warp's two rows (a broadcast); the W tile is read by lanes on
//     consecutive addresses.
//   - bf16: lstm_cell_mma_kernel. 4 warps, one m16 tile of 16 rows; warp w
//     takes hidden columns 8w..8w+7 of the block's 32 and runs one m16n8k16
//     product per gate, so each thread's accumulator fragments hold the
//     same (row, column) positions for all four gates. W is staged
//     transposed so that a B fragment is one 32-bit load.
// No cp.async/TMA pipeline, no wgmma, and Wh is read from device memory
// (L2) at every step: a persistent kernel that keeps Wh on chip across time
// steps is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// The cell for one (row, column): z of the four gates, the previous c.
template <typename T>
__device__ __forceinline__ void apply_cell(float zi, float zf, float zo,
                                           float zg, const T* c, T* h_out,
                                           T* c_out) {
  const float i = sigmoid(zi);
  const float f = sigmoid(zf);
  const float o = sigmoid(zo);
  const float g = tanhf(zg);
  const float cn = __fadd_rn(__fmul_rn(f, to_f32(*c)), __fmul_rn(i, g));
  store(c_out, cn);
  store(h_out, __fmul_rn(o, tanhf(cn)));
}

// ------------------------------------------------------------------- f32

constexpr int kBN = 32;             // hidden columns per block: one a lane
constexpr int kWarps = 8;
constexpr int kTM = 2;              // batch rows per warp
constexpr int kBM = kWarps * kTM;   // 16 batch rows per block
constexpr int kBK = 32;             // K depth of one shared tile
constexpr int kThreads = kWarps * 32;
constexpr int kXLd = kBM + 2;       // even (8-byte loads), 16 banks apart

// acc[r][g] += src[row0 + 2w + r, :K] . w[:K, g*H + col0 + lane]
__device__ __forceinline__ void accumulate_f32(
    const float* __restrict__ src, long long s_src, int K,
    const float* __restrict__ w, long long s_w, int B, int H, int row0,
    int col0, float* xs, float* ws, float (&acc)[kTM][4]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK;
      const int kk = idx - r * kBK;
      const int row = row0 + r;
      const int k = k0 + kk;
      xs[kk * kXLd + r] =
          (row < B && k < K) ? src[(long long)row * s_src + k] : 0.f;
    }
    for (int idx = tid; idx < kBK * 4 * kBN; idx += kThreads) {
      const int jj = idx % kBN;
      const int g = (idx / kBN) & 3;
      const int kk = idx / (4 * kBN);
      const int k = k0 + kk;
      const int col = col0 + jj;
      ws[idx] = (k < K && col < H)
                    ? w[(long long)k * s_w + (long long)g * H + col]
                    : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float2 xv =
          *reinterpret_cast<const float2*>(xs + kk * kXLd + warp * kTM);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float wv = ws[(kk * 4 + g) * kBN + lane];
        acc[0][g] = fmaf(xv.x, wv, acc[0][g]);
        acc[1][g] = fmaf(xv.y, wv, acc[1][g]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_cell_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ c, const float* __restrict__ wx,
                     const float* __restrict__ wh, const float* __restrict__ b,
                     float* __restrict__ h_out, float* __restrict__ c_out,
                     int B, int I, int H, long long x_s, long long h_s,
                     long long c_s, long long wx_s, long long wh_s) {
  __shared__ __align__(16) float xs[kBK * kXLd];
  __shared__ __align__(16) float ws[kBK * 4 * kBN];
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  float zx[kTM][4], zh[kTM][4];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) zx[r][g] = zh[r][g] = 0.f;
  accumulate_f32(x, x_s, I, wx, wx_s, B, H, row0, col0, xs, ws, zx);
  accumulate_f32(h, h_s, H, wh, wh_s, B, H, row0, col0, xs, ws, zh);

  const int warp = threadIdx.x >> 5;
  const int col = col0 + (threadIdx.x & 31);
  if (col >= H) return;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = b[g * H + col];
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int row = row0 + warp * kTM + r;
    if (row >= B) continue;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g] = (zx[r][g] + zh[r][g]) + bias[g];
    apply_cell(z[0], z[1], z[2], z[3], c + (long long)row * c_s + col,
               h_out + (long long)row * H + col,
               c_out + (long long)row * H + col);
  }
}

// ------------------------------------------------------------ bf16, mma.sync

constexpr int kMmaBM = 16;                  // one m16 tile of batch rows
constexpr int kMmaWarps = 4;
constexpr int kMmaBN = kMmaWarps * 8;       // 32 hidden columns per block
constexpr int kMmaBK = 32;                  // two k16 steps per tile
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kLdK = kMmaBK + 8;  // bf16 row stride: fragment loads of the 8
                                  // rows a quad group touches hit 32 banks

// d (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[g] (the m16n8 fragment of gate g, this warp's 8 columns) +=
//   src[row0 : row0 + 16, :K] . w[:K, g*H + col0 + 8w : ... + 8]
__device__ __forceinline__ void accumulate_mma(
    const bf16* __restrict__ src, long long s_src, int K,
    const bf16* __restrict__ w, long long s_w, int B, int H, int row0,
    int col0, bf16* xs, bf16* ws, float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row (and row + 8) / B column
  const int tq = lane & 3;   // fragment k pair
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    __syncthreads();
    // x or h tile, row-major [16][kLdK]
    for (int idx = tid; idx < kMmaBM * kMmaBK; idx += kMmaThreads) {
      const int r = idx / kMmaBK;
      const int kk = idx - r * kMmaBK;
      const int row = row0 + r;
      const int k = k0 + kk;
      xs[r * kLdK + kk] =
          (row < B && k < K) ? src[(long long)row * s_src + k] : zero;
    }
    // W tile transposed, [4 gates * 32 columns][kLdK]
    for (int idx = tid; idx < kMmaBK * 4 * kMmaBN; idx += kMmaThreads) {
      const int jj = idx % kMmaBN;
      const int g = (idx / kMmaBN) & 3;
      const int kk = idx / (4 * kMmaBN);
      const int k = k0 + kk;
      const int col = col0 + jj;
      ws[(g * kMmaBN + jj) * kLdK + kk] =
          (k < K && col < H) ? w[(long long)k * s_w + (long long)g * H + col]
                             : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      const bf16* ab = xs + gq * kLdK + ks * 16 + 2 * tq;
      const uint32_t a[4] = {ld32(ab), ld32(ab + 8 * kLdK), ld32(ab + 8),
                             ld32(ab + 8 * kLdK + 8)};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const bf16* bb =
            ws + (g * kMmaBN + warp * 8 + gq) * kLdK + ks * 16 + 2 * tq;
        mma_bf16(acc[g], a, ld32(bb), ld32(bb + 8));
      }
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
lstm_cell_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                     const bf16* __restrict__ c, const bf16* __restrict__ wx,
                     const bf16* __restrict__ wh, const bf16* __restrict__ b,
                     bf16* __restrict__ h_out, bf16* __restrict__ c_out, int B,
                     int I, int H, long long x_s, long long h_s, long long c_s,
                     long long wx_s, long long wh_s) {
  __shared__ __align__(16) bf16 xs[kMmaBM * kLdK];
  __shared__ __align__(16) bf16 ws[4 * kMmaBN * kLdK];
  const int row0 = blockIdx.x * kMmaBM;
  const int col0 = blockIdx.y * kMmaBN;
  float zx[4][4], zh[4][4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) zx[g][e] = zh[g][e] = 0.f;
  accumulate_mma(x, x_s, I, wx, wx_s, B, H, row0, col0, xs, ws, zx);
  accumulate_mma(h, h_s, H, wh, wh_s, B, H, row0, col0, xs, ws, zh);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // fragment element e sits at row gq + 8 * (e >> 1), column 2 tq + (e & 1)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row0 + (lane >> 2) + 8 * (e >> 1);
    const int col = col0 + warp * 8 + 2 * (lane & 3) + (e & 1);
    if (row >= B || col >= H) continue;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      z[g] = (zx[g][e] + zh[g][e]) + __bfloat162float(b[g * H + col]);
    apply_cell(z[0], z[1], z[2], z[3], c + (long long)row * c_s + col,
               h_out + (long long)row * H + col,
               c_out + (long long)row * H + col);
  }
}

}  // namespace

// x [B, I], h and c [B, H], wx [I, 4H], wh [H, 4H]: unit stride over the
// last dimension, row strides (elements) passed. b: contiguous [4H].
// h_out, c_out: contiguous [B, H]. All of one type; dtype: 0 = f32,
// 1 = bf16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lstm_cell(const void* x, const void* h, const void* c,
                         const void* wx, const void* wh, const void* b,
                         void* h_out, void* c_out, int B, int I, int H,
                         long long x_s, long long h_s, long long c_s,
                         long long wx_s, long long wh_s, int dtype,
                         void* stream) {
  if (B < 1 || I < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dim3 grid((B + kBM - 1) / kBM, (H + kBN - 1) / kBN);
    lstm_cell_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(h),
        static_cast<const float*>(c), static_cast<const float*>(wx),
        static_cast<const float*>(wh), static_cast<const float*>(b),
        static_cast<float*>(h_out), static_cast<float*>(c_out), B, I, H, x_s,
        h_s, c_s, wx_s, wh_s);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    dim3 grid((B + kMmaBM - 1) / kMmaBM, (H + kMmaBN - 1) / kMmaBN);
    lstm_cell_mma_kernel<<<grid, kMmaThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(h),
        static_cast<const bf16*>(c), static_cast<const bf16*>(wx),
        static_cast<const bf16*>(wh), static_cast<const bf16*>(b),
        static_cast<bf16*>(h_out), static_cast<bf16*>(c_out), B, I, H, x_s,
        h_s, c_s, wx_s, wh_s);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
