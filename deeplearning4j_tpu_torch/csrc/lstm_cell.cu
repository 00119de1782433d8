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
// mma.sync m16n8k16 with f32 sums, each K slice summed apart. sigmoid is
// 1 / (1 + exp(-x)), with the full-precision expf and tanhf, and c' is
// f*c + i*g without contraction.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 989 bf16,
// 3.35 TB/s HBM), for x [B, I], h and c [B, H], W [(I + H), 4H]:
//   operations 2*B*(I + H)*4H, bytes (B*I + 2*B*H + (I + H)*4H + 4H) read
//   plus 2*B*H written, times the element size.
// At the bench shape (f32, B = 256, I = H = 256) that is 2.68e8 FLOP, about
// 4.0 us at 67 TFLOP/s, against about 3.4 MB, about 1.0 us: bound by
// operations. A 64-step, 4-layer forward launches this kernel 256 times, so
// it cannot take less than about 1 ms. In bf16 the same shape is about
// 0.27 us of operations at 989 TFLOP/s against 1.7 MB, about 0.51 us:
// bound by bytes, and in practice by the latency of one pass of loads.
//
// Design. One block owns a tile of batch rows and a tile of hidden columns
// j, and computes the four gate columns j, H + j, 2H + j, 3H + j of z for
// it, so the four gates of every (row, column) meet in one block and the
// cell is applied there. Ragged B, I and H are zero-filled on load and
// masked on store: there is no fallback. Operands may be row-strided views
// (a time step of [B, T, I], the two row blocks of one fused W); the last
// dimension must have unit stride.
//   - f32: lstm_cell_f32_kernel. A block is 32 rows x 16 columns x 4 gates
//     (at the bench shape 8 x 16 = 128 blocks for the 132 SMs: one wave)
//     and runs K slices of 64 threads: eight where the grid is under one
//     block an SM (the bench shape), four where it fills the card (the
//     CLI's). The first slices take x.Wx, the others h.Wh, split so that
//     the largest slice has the fewest tiles. A thread keeps 2 rows x 4
//     columns x 4 gates (32 sums) in registers: per k one float of each
//     row and one float4 per gate, so 36 shared loads feed 256 FMAs of an
//     8-deep tile. Each slice streams its x (or h) and W tiles with
//     cp.async (16-byte chunks where rows and gate slices are 4-float
//     aligned, single floats otherwise) into its own 3-stage ring, synced
//     by a named barrier of its 64 threads, so the copy of the next tiles
//     runs while this one is multiplied; the bias and the previous c are
//     fetched before the products. The slices' partial sums meet in shared
//     memory: z = ((x.Wx slices, in order) + (h.Wh slices, in order)) + b,
//     and each thread applies the cell to its (row, column) pairs. A block
//     reads 128 KB of W and 64 KB of x and h (24.6 MB from L2 a launch at
//     the bench shape, against 36 MB for 16 x 32 tiles).
//   - bf16: lstm_cell_bf16_kernel. The f32 body's block (32 rows x 16
//     columns x 4 gates: 128 blocks at the bench shape) on the bf16 tensor
//     cores: each warp is one K slice (eight where the grid is under one
//     block an SM, four where it fills the card, x.Wx and h.Wh split as in
//     f32) and computes the block's whole 32 x 64 z over its slice, two
//     m16 row tiles by eight n8 gate-column tiles of m16n8k16 mma.sync (64
//     f32 sums a thread). It streams its x (or h) and W tiles in their own
//     layouts with 16-byte cp.async chunks (element by element where rows
//     or gate slices are not 8-element aligned) into a 2-stage ring of its
//     own, synced by __syncwarp alone, so the copy of tile t + 1 runs while
//     tile t is multiplied; A fragments come from the [row][k] tile by
//     ldmatrix and B fragments from the [k][n] tile by ldmatrix.trans,
//     rows padded by 16 bytes so that no ldmatrix meets a bank conflict.
//     The warps' partial sums meet in shared memory over the rings and are
//     added in a fixed order, z = ((x.Wx slices) + (h.Wh slices)) + b, as
//     in f32. (The first bf16 body staged W transposed one element a
//     thread by scalar loads between two __syncthreads, in 4-warp blocks
//     that each ran the whole K: 0.054 ms at the bench shape.)
// No TMA and no wgmma (f32 stays off the tensor cores; bf16 tiles of 32
// rows are below wgmma's 64), and Wh is read from device memory (L2) at
// every step: a persistent kernel that keeps Wh on chip across time steps
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "warp_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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
                                           float zg, float c, T* h_out,
                                           T* c_out) {
  const float i = sigmoid(zi);
  const float f = sigmoid(zf);
  const float o = sigmoid(zo);
  const float g = tanhf(zg);
  const float cn = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g));
  store(c_out, cn);
  store(h_out, __fmul_rn(o, tanhf(cn)));
}

// ------------------------------------------------------------------- f32

constexpr int kBM = 32;             // batch rows per block
constexpr int kBN = 16;             // hidden columns per block (x 4 gates)
constexpr int kBK = 8;              // K depth of one staged tile
constexpr int kStages = 3;          // depth of each slice's cp.async ring
constexpr int kTR = 2;              // rows of a thread, kBM / kTR apart
constexpr int kSliceThreads = kBM / kTR * 4;  // row groups x column quads
// K slices of a block: many where the grid is under one block an SM, few
// where it fills the card
constexpr int kSlicesFew = 4, kSlicesMany = 8;
constexpr int kXLd = kBK + 4;       // x tile row: 16-byte aligned, and the
                                    // float4 reads of 8 rows hit 8 bank quads
constexpr int kXTile = kBM * kXLd;  // floats of one staged x (or h) tile
constexpr int kWTile = kBK * 4 * kBN;  // floats of one staged W tile
constexpr int kStage = kXTile + kWTile;
constexpr int kRing = kStages * kStage;  // floats of one slice's ring

using warp_mma::cp_async;
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;

// Start the copy of one K tile of a slice: src rows [row0, row0 + kBM) x
// k [k, k + kBK) into xs ([row][kXLd]), and the four gate column slices
// w[k .. k + kBK, g*H + col0 .. + kBN] into ws ([k][gate][kBN]); zeros past
// B, past the slice's end k_end and past H. The 64 threads of the slice
// take the chunks in turn (`lt`: the thread's index in the slice).
template <int kVec>
__device__ __forceinline__ void load_stage(float* xs, float* ws,
                                           const float* __restrict__ src,
                                           long long s_src,
                                           const float* __restrict__ w,
                                           long long s_w, int B, int H,
                                           int row0, int col0, int k,
                                           int k_end, int lt) {
  constexpr int kXRow = kBK / kVec;  // chunks per staged row of x
  static_assert(kBM * kXRow % kSliceThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int n = 0; n < kBM * kXRow / kSliceThreads; ++n) {
    const int i = lt + n * kSliceThreads;
    const int r = i / kXRow;
    const int kk = (i % kXRow) * kVec;
    const int row = row0 + r;
    const int left = k_end - (k + kk);
    const int valid = row < B && left > 0 ? (left < kVec ? left : kVec) : 0;
    cp_async<kVec>(xs + r * kXLd + kk,
                   valid ? src + (long long)row * s_src + k + kk : src,
                   valid);
  }
  constexpr int kWRow = kBN / kVec;  // chunks per gate slice of a W row
  static_assert(kBK * 4 * kWRow % kSliceThreads == 0, "whole rounds");
#pragma unroll
  for (int n = 0; n < kBK * 4 * kWRow / kSliceThreads; ++n) {
    const int i = lt + n * kSliceThreads;
    const int jj = (i % kWRow) * kVec;
    const int g = (i / kWRow) % 4;
    const int kk = i / (4 * kWRow);
    const int left = H - (col0 + jj);
    const int valid =
        k + kk < k_end && left > 0 ? (left < kVec ? left : kVec) : 0;
    cp_async<kVec>(ws + (kk * 4 + g) * kBN + jj,
                   valid ? w + (long long)(k + kk) * s_w + (long long)g * H +
                               col0 + jj
                         : w,
                   valid);
  }
}

// acc[r][g][c] += src[row0 + rg + r kBM / kTR, k_begin:k_end] .
//                 w[k_begin:k_end, g*H + col0 + 4 q + c]
// over one slice's K range, through its ring of kStages tiles: the copy of
// tile t + kStages - 1 runs while tile t is multiplied. Named barrier
// 1 + slice syncs the slice's threads.
template <int kVec>
__device__ __forceinline__ void accumulate_slice(
    const float* __restrict__ src, long long s_src,
    const float* __restrict__ w, long long s_w, int B, int H, int row0,
    int col0, int k_begin, int k_end, int slice, float* ring,
    float (&acc)[kTR][4][4]) {
  const int lt = threadIdx.x % kSliceThreads;
  const int q = lt % 4, rg = lt / 4;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles)
      load_stage<kVec>(ring + t * kStage, ring + t * kStage + kXTile, src,
                       s_src, w, s_w, B, H, row0, col0, k_begin + t * kBK,
                       k_end, lt);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
    // every thread's copies of tile t landed, and tile t - 1 is consumed:
    // its stage takes tile t + kStages - 1
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slice), "n"(kSliceThreads)
                 : "memory");
    const int next = t + kStages - 1;
    if (next < ntiles) {
      float* st = ring + (next % kStages) * kStage;
      load_stage<kVec>(st, st + kXTile, src, s_src, w, s_w, B, H, row0,
                       col0, k_begin + next * kBK, k_end, lt);
    }
    cp_async_commit();
    const float* xs = ring + (t % kStages) * kStage;
    const float* ws = xs + kXTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float xv[kTR][4];  // 4 k of each of the thread's rows
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float4 xa = *reinterpret_cast<const float4*>(
            xs + (rg + r * (kBM / kTR)) * kXLd + kk);
        xv[r][0] = xa.x, xv[r][1] = xa.y, xv[r][2] = xa.z, xv[r][3] = xa.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 wv = *reinterpret_cast<const float4*>(
              ws + ((kk + j) * 4 + g) * kBN + 4 * q);
          const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int r = 0; r < kTR; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][g][c] = fmaf(xv[r][j], wc[c], acc[r][g][c]);
        }
    }
  }
}

// z over the K slices of one block: x.Wx is cut into the first nx slices
// and h.Wh into the other kSlices - nx, each part's kBK-deep tiles dealt
// out evenly; each slice copies 16-byte chunks where its operands' rows and
// gate slices are 4-float aligned (vec_x, vec_h), single floats otherwise.
template <int kSlices>
__global__ void __launch_bounds__(kSlices * kSliceThreads)
lstm_cell_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ c, const float* __restrict__ wx,
                     const float* __restrict__ wh, const float* __restrict__ b,
                     float* __restrict__ h_out, float* __restrict__ c_out,
                     int B, int I, int H, long long x_s, long long h_s,
                     long long c_s, long long wx_s, long long wh_s, int nx,
                     int vec_x, int vec_h) {
  // each slice's ring; after the products, the slices' partial z
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  static_assert(4 * kBM * kBN <= kRing, "the partial sums reuse the rings");
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int slice = threadIdx.x / kSliceThreads;
  const int lt = threadIdx.x % kSliceThreads;
  const int q = lt % 4, rg = lt / 4;

  float acc[kTR][4][4];
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][g][e] = 0.f;
  const bool on_x = slice < nx;
  const int K = on_x ? I : H;
  const int n = on_x ? nx : kSlices - nx;  // slices of this part
  const int j = on_x ? slice : slice - nx;  // this slice's place in it
  const int tiles = (K + kBK - 1) / kBK;
  const int k_begin = j * tiles / n * kBK;
  int k_end = (j + 1) * tiles / n * kBK;
  k_end = k_end < K ? k_end : K;
  // the cells this thread finishes: their bias and previous c are fetched
  // now, so that the loads' latency hides under the products
  constexpr int kThreads = kSlices * kSliceThreads;
  static_assert(kBM * kBN % kThreads == 0, "whole cells a thread");
  constexpr int kCells = kBM * kBN / kThreads;
  float bias[kCells][4], c_prev[kCells];
#pragma unroll
  for (int m = 0; m < kCells; ++m) {
    const int cell = threadIdx.x + m * kThreads;
    const int row = row0 + cell / kBN, col = col0 + cell % kBN;
    const bool in = row < B && col < H;
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[m][g] = in ? b[g * H + col] : 0.f;
    c_prev[m] = in ? c[(long long)row * c_s + col] : 0.f;
  }
  float* ring = smem + slice * kRing;
  if (on_x ? vec_x : vec_h)
    accumulate_slice<4>(on_x ? x : h, on_x ? x_s : h_s, on_x ? wx : wh,
                        on_x ? wx_s : wh_s, B, H, row0, col0, k_begin, k_end,
                        slice, ring, acc);
  else
    accumulate_slice<1>(on_x ? x : h, on_x ? x_s : h_s, on_x ? wx : wh,
                        on_x ? wx_s : wh_s, B, H, row0, col0, k_begin, k_end,
                        slice, ring, acc);

  // partial z of each slice, [slice][gate][row][column], in the rings
  cp_async_wait<0>();
  __syncthreads();
  float* part = smem;
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      *reinterpret_cast<float4*>(
          part + ((slice * 4 + g) * kBM + rg + r * (kBM / kTR)) * kBN +
          4 * q) =
          make_float4(acc[r][g][0], acc[r][g][1], acc[r][g][2],
                      acc[r][g][3]);
  __syncthreads();

  // z = (x.Wx + h.Wh) + b, each product the sum of its slices in order, and
  // the cell
  constexpr int kPart = 4 * kBM * kBN;  // floats of one slice's partial z
#pragma unroll
  for (int m = 0; m < kCells; ++m) {
    const int cell = threadIdx.x + m * kThreads;
    const int r = cell / kBN, jj = cell % kBN;
    const int row = row0 + r, col = col0 + jj;
    if (row >= B || col >= H) continue;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float* p = part + (g * kBM + r) * kBN + jj;
      float zx = p[0], zh = p[nx * kPart];
      for (int t = 1; t < nx; ++t) zx += p[t * kPart];
      for (int t = nx + 1; t < kSlices; ++t) zh += p[t * kPart];
      z[g] = (zx + zh) + bias[m][g];
    }
    apply_cell(z[0], z[1], z[2], z[3], c_prev[m],
               h_out + (long long)row * H + col,
               c_out + (long long)row * H + col);
  }
}

constexpr int kMaxDevices = 64;

// The dynamic shared memory limit of `kernel` raised to `bytes` once per
// device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// The split of kSlices K slices between x.Wx (tx tiles) and h.Wh (th
// tiles) that leaves the largest slice the fewest tiles: the x slices.
inline int split_slices(int slices, int tx, int th) {
  int nx = 1, best = INT_MAX;
  for (int cand = 1; cand < slices; ++cand) {
    const int hs = slices - cand;
    const int most = std::max((tx + cand - 1) / cand, (th + hs - 1) / hs);
    if (most < best) best = most, nx = cand;
  }
  return nx;
}

// The launch of the f32 body with kSlices K slices.
template <int kSlices>
cudaError_t launch_f32(const float* x, const float* h, const float* c,
                       const float* wx, const float* wh, const float* b,
                       float* h_out, float* c_out, int B, int I, int H,
                       long long x_s, long long h_s, long long c_s,
                       long long wx_s, long long wh_s, cudaStream_t st) {
  auto kernel = lstm_cell_f32_kernel<kSlices>;
  const size_t smem = sizeof(float) * kSlices * kRing;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int nx = split_slices(kSlices, (I + kBK - 1) / kBK,
                              (H + kBK - 1) / kBK);
  // 16-byte copies need 4-float aligned rows, gate slices and bases
  const bool vec_w = H % 4 == 0;
  const int vec_x = vec_w && x_s % 4 == 0 && wx_s % 4 == 0 &&
                    ((uintptr_t)x | (uintptr_t)wx) % 16 == 0;
  const int vec_h = vec_w && h_s % 4 == 0 && wh_s % 4 == 0 &&
                    ((uintptr_t)h | (uintptr_t)wh) % 16 == 0;
  dim3 grid((B + kBM - 1) / kBM, (H + kBN - 1) / kBN);
  kernel<<<grid, kSlices * kSliceThreads, smem, st>>>(
      x, h, c, wx, wh, b, h_out, c_out, B, I, H, x_s, h_s, c_s, wx_s, wh_s,
      nx, vec_x, vec_h);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16, mma.sync

constexpr int kHBM = 32;            // batch rows per block (two m16 tiles)
constexpr int kHBN = 16;            // hidden columns per block
constexpr int kHN = 4 * kHBN;       // gate columns per block (eight n8 tiles)
constexpr int kHBK = 32;            // K depth of one staged tile (two k16)
constexpr int kHStages = 2;         // depth of each warp's cp.async ring
constexpr int kALd = kHBK + 8;      // bf16 row of a staged x (or h) tile:
constexpr int kBLd = kHN + 8;       // and of a W tile: the 8 rows that one
                                    // ldmatrix matrix reads hit 8 distinct
                                    // 16-byte bank groups
constexpr int kATile = kHBM * kALd;
constexpr int kBTile = kHBK * kBLd;
constexpr int kHStage = kATile + kBTile;   // bf16 of one stage
constexpr int kHRing = kHStages * kHStage;  // bf16 of one warp's ring
constexpr int kPLd = kHN + 8;       // f32 row of a warp's partial z: the
                                    // float2 stores of a half warp hit 32
                                    // banks
// K slices (warps) of a block: many where the grid is under one block an
// SM (the bench shape), few where it fills the card
constexpr int kHSlicesFew = 4, kHSlicesMany = 8;
static_assert(kHBM * kPLd * 4 <= kHRing * 2,
              "a warp's partial z fits in its ring");

// d (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands each thread a column pair instead
// of a row pair (the B fragment of a [k][n] tile).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// Copy `bytes` (at most 16) of a 16-byte chunk from global to shared
// memory asynchronously, zero-filling the rest of the chunk.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// Stage one K tile of a warp's slice: src rows [row0, row0 + kHBM) x k
// [k, k + kHBK) into as ([row][kALd]), and the four gate column slices
// w[k .. k + kHBK, g*H + col0 .. + kHBN] into bs ([k][gate*kHBN + j]);
// zeros past B, past the slice's end k_end and past H. Each operand goes
// in 16-byte cp.async chunks where its rows (and, for W, the gate slices)
// are 8-element aligned (vec_src, vec_w), else element by element.
__device__ __forceinline__ void load_stage_bf16(
    bf16* as, bf16* bs, const bf16* __restrict__ src, long long s_src,
    const bf16* __restrict__ w, long long s_w, int B, int H, int row0,
    int col0, int k, int k_end, bool vec_src, bool vec_w, int lane) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (vec_src) {
#pragma unroll
    for (int n = 0; n < kHBM * kHBK / 8 / 32; ++n) {
      const int i = lane + 32 * n;
      const int r = i / (kHBK / 8), kk = (i % (kHBK / 8)) * 8;
      const int row = row0 + r, left = k_end - (k + kk);
      const int valid = row < B && left > 0 ? (left < 8 ? left : 8) : 0;
      cp_async16(as + r * kALd + kk,
                 valid ? src + (long long)row * s_src + k + kk : src,
                 2 * valid);
    }
  } else {
    for (int i = lane; i < kHBM * kHBK; i += 32) {
      const int r = i / kHBK, kk = i % kHBK;
      const int row = row0 + r;
      as[r * kALd + kk] = row < B && k + kk < k_end
                              ? src[(long long)row * s_src + k + kk]
                              : zero;
    }
  }
  if (vec_w) {
#pragma unroll
    for (int n = 0; n < kHBK * kHN / 8 / 32; ++n) {
      const int i = lane + 32 * n;
      const int kk = i / (kHN / 8), c = (i % (kHN / 8)) * 8;
      const int g = c / kHBN, jj = c % kHBN;
      const int left = H - (col0 + jj);
      const int valid =
          k + kk < k_end && left > 0 ? (left < 8 ? left : 8) : 0;
      cp_async16(bs + kk * kBLd + c,
                 valid ? w + (long long)(k + kk) * s_w + (long long)g * H +
                             col0 + jj
                       : w,
                 2 * valid);
    }
  } else {
    for (int i = lane; i < kHBK * kHN; i += 32) {
      const int kk = i / kHN, c = i % kHN;
      const int col = col0 + c % kHBN;
      bs[kk * kBLd + c] =
          k + kk < k_end && col < H
              ? w[(long long)(k + kk) * s_w + (long long)(c / kHBN) * H + col]
              : zero;
    }
  }
}

// acc[mt][nt] (the m16n8 fragment of rows 16 mt.., gate columns 8 nt..) +=
//   src[row0 .., k_begin:k_end] . w[k_begin:k_end, the block's 4 x kHBN]
// over one warp's K slice, through the warp's own ring of kHStages tiles:
// the copy of tile t + 1 runs while tile t is multiplied. A fragments come
// from the [row][k] tile by ldmatrix, B fragments from the [k][n] tile by
// ldmatrix.trans; only the warp syncs (__syncwarp).
__device__ __forceinline__ void accumulate_slice_bf16(
    const bf16* __restrict__ src, long long s_src,
    const bf16* __restrict__ w, long long s_w, int B, int H, int row0,
    int col0, int k_begin, int k_end, bool vec_src, bool vec_w, bf16* ring,
    float (&acc)[2][8][4]) {
  const int lane = threadIdx.x & 31;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kHBK - 1) / kHBK : 0;
#pragma unroll
  for (int t = 0; t < kHStages - 1; ++t) {
    if (t < ntiles)
      load_stage_bf16(ring + t * kHStage, ring + t * kHStage + kATile, src,
                      s_src, w, s_w, B, H, row0, col0, k_begin + t * kHBK,
                      k_end, vec_src, vec_w, lane);
    warp_mma::cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    // the stage of tile t + kHStages - 1 was read in iteration t - 1, which
    // ended with a __syncwarp
    const int next = t + kHStages - 1;
    if (next < ntiles) {
      bf16* st = ring + (next % kHStages) * kHStage;
      load_stage_bf16(st, st + kATile, src, s_src, w, s_w, B, H, row0, col0,
                      k_begin + next * kHBK, k_end, vec_src, vec_w, lane);
    }
    warp_mma::cp_async_commit();
    warp_mma::cp_async_wait<kHStages - 1>();  // this lane's tile t landed
    __syncwarp();                             // every lane's did
    const bf16* as = ring + (t % kHStages) * kHStage;
    const bf16* bs = as + kATile;
#pragma unroll
    for (int ks = 0; ks < kHBK / 16; ++ks) {
      uint32_t a[2][4], b[4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4<false>(a[mt], as + (mt * 16 + (lane & 15)) * kALd +
                                      ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldmatrix_x4<true>(b[np], bs + (ks * 16 + (lane & 15)) * kBLd +
                                     np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt / 2][2 * (nt % 2)],
                   b[nt / 2][2 * (nt % 2) + 1]);
    }
    __syncwarp();  // the stage is read before it takes tile t + kHStages
  }
}

// z over the K slices of one block: one warp a slice, x.Wx cut into the
// first nx slices and h.Wh into the other kSlices - nx, each part's
// kHBK-deep tiles dealt out evenly.
template <int kSlices>
__global__ void __launch_bounds__(kSlices * 32)
lstm_cell_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                      const bf16* __restrict__ c, const bf16* __restrict__ wx,
                      const bf16* __restrict__ wh, const bf16* __restrict__ b,
                      bf16* __restrict__ h_out, bf16* __restrict__ c_out,
                      int B, int I, int H, long long x_s, long long h_s,
                      long long c_s, long long wx_s, long long wh_s, int nx,
                      int vec_x, int vec_wx, int vec_h, int vec_wh) {
  // each warp's ring; after the products, the warps' partial z
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int row0 = blockIdx.x * kHBM;
  const int col0 = blockIdx.y * kHBN;
  const int slice = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const bool on_x = slice < nx;
  const int K = on_x ? I : H;
  const int n = on_x ? nx : kSlices - nx;   // slices of this part
  const int j = on_x ? slice : slice - nx;  // this slice's place in it
  const int tiles = (K + kHBK - 1) / kHBK;
  const int k_begin = j * tiles / n * kHBK;
  int k_end = (j + 1) * tiles / n * kHBK;
  k_end = k_end < K ? k_end : K;
  // the cells this thread finishes: their bias and previous c are fetched
  // now, so that the loads' latency hides under the products
  constexpr int kThreads = kSlices * 32;
  static_assert(kHBM * kHBN % kThreads == 0, "whole cells a thread");
  constexpr int kCells = kHBM * kHBN / kThreads;
  float bias[kCells][4], c_prev[kCells];
#pragma unroll
  for (int m = 0; m < kCells; ++m) {
    const int cell = threadIdx.x + m * kThreads;
    const int row = row0 + cell / kHBN, col = col0 + cell % kHBN;
    const bool in = row < B && col < H;
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[m][g] = in ? to_f32(b[g * H + col]) : 0.f;
    c_prev[m] = in ? to_f32(c[(long long)row * c_s + col]) : 0.f;
  }
  accumulate_slice_bf16(on_x ? x : h, on_x ? x_s : h_s, on_x ? wx : wh,
                        on_x ? wx_s : wh_s, B, H, row0, col0, k_begin, k_end,
                        on_x ? vec_x : vec_h, on_x ? vec_wx : vec_wh,
                        smem + slice * kHRing, acc);

  // partial z of each slice, [slice][row][gate column], over the rings
  warp_mma::cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem) + slice * kHBM * kPLd;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(
            part + (mt * 16 + (lane >> 2) + 8 * hf) * kPLd + nt * 8 +
            2 * (lane & 3)) =
            make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
  __syncthreads();

  // z = (x.Wx + h.Wh) + b, each product the sum of its slices in order, and
  // the cell
  const float* parts = reinterpret_cast<const float*>(smem);
  constexpr int kPart = kHBM * kPLd;  // floats of one slice's partial z
#pragma unroll
  for (int m = 0; m < kCells; ++m) {
    const int cell = threadIdx.x + m * kThreads;
    const int r = cell / kHBN, jj = cell % kHBN;
    const int row = row0 + r, col = col0 + jj;
    if (row >= B || col >= H) continue;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float* p = parts + r * kPLd + g * kHBN + jj;
      float zx = p[0], zh = p[nx * kPart];
      for (int t = 1; t < nx; ++t) zx += p[t * kPart];
      for (int t = nx + 1; t < kSlices; ++t) zh += p[t * kPart];
      z[g] = (zx + zh) + bias[m][g];
    }
    apply_cell(z[0], z[1], z[2], z[3], c_prev[m],
               h_out + (long long)row * H + col,
               c_out + (long long)row * H + col);
  }
}

// The launch of the bf16 body with kSlices warps.
template <int kSlices>
cudaError_t launch_bf16(const bf16* x, const bf16* h, const bf16* c,
                        const bf16* wx, const bf16* wh, const bf16* b,
                        bf16* h_out, bf16* c_out, int B, int I, int H,
                        long long x_s, long long h_s, long long c_s,
                        long long wx_s, long long wh_s, cudaStream_t st) {
  auto kernel = lstm_cell_bf16_kernel<kSlices>;
  const size_t smem = sizeof(bf16) * kSlices * kHRing;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int nx = split_slices(kSlices, (I + kHBK - 1) / kHBK,
                              (H + kHBK - 1) / kHBK);
  // 16-byte copies need 8-element aligned rows and bases; W's gate slices
  // start at multiples of H
  auto vec = [](const bf16* p, long long s) {
    return (int)(s % 8 == 0 && (uintptr_t)p % 16 == 0);
  };
  const int wvec = H % 8 == 0;
  dim3 grid((B + kHBM - 1) / kHBM, (H + kHBN - 1) / kHBN);
  kernel<<<grid, kSlices * 32, smem, st>>>(
      x, h, c, wx, wh, b, h_out, c_out, B, I, H, x_s, h_s, c_s, wx_s, wh_s,
      nx, vec(x, x_s), wvec && vec(wx, wx_s), vec(h, h_s),
      wvec && vec(wh, wh_s));
  return cudaGetLastError();
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
  // both bodies take eight K slices where the grid is under one block an
  // SM (the bench shape: 128 blocks), four where it fills the card
  static std::atomic<int> sms_seen{0};
  int sms = sms_seen.load();
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_seen.store(sms);
  }
  if (dtype == 0) {
    const long long blocks =
        (long long)((B + kBM - 1) / kBM) * ((H + kBN - 1) / kBN);
#define DL4J_LSTM_ARGS                                                      \
  static_cast<const float*>(x), static_cast<const float*>(h),               \
      static_cast<const float*>(c), static_cast<const float*>(wx),          \
      static_cast<const float*>(wh), static_cast<const float*>(b),          \
      static_cast<float*>(h_out), static_cast<float*>(c_out), B, I, H, x_s, \
      h_s, c_s, wx_s, wh_s, st
    const cudaError_t err = blocks <= sms
                                ? launch_f32<kSlicesMany>(DL4J_LSTM_ARGS)
                                : launch_f32<kSlicesFew>(DL4J_LSTM_ARGS);
#undef DL4J_LSTM_ARGS
    return (int)err;
  }
  if (dtype == 1) {
#define DL4J_LSTM_ARGS                                                     \
  static_cast<const bf16*>(x), static_cast<const bf16*>(h),                \
      static_cast<const bf16*>(c), static_cast<const bf16*>(wx),           \
      static_cast<const bf16*>(wh), static_cast<const bf16*>(b),           \
      static_cast<bf16*>(h_out), static_cast<bf16*>(c_out), B, I, H, x_s,  \
      h_s, c_s, wx_s, wh_s, st
    const long long blocks =
        (long long)((B + kHBM - 1) / kHBM) * ((H + kHBN - 1) / kHBN);
    const cudaError_t err = blocks <= sms
                                ? launch_bf16<kHSlicesMany>(DL4J_LSTM_ARGS)
                                : launch_bf16<kHSlicesFew>(DL4J_LSTM_ARGS);
#undef DL4J_LSTM_ARGS
    return (int)err;
  }
  return (int)cudaErrorInvalidValue;
}
