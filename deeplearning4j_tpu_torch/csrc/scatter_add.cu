// Embedding-row scatter-add for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_scatter_add_kernel` / `scatter_add_rows` in
// deeplearning4j_tpu/nd/pallas_kernels.py (:600-663):
//   table[idx[n]] += upd[n]   for n in [0, N), duplicate indices accumulating,
// in the table's own type. On the path it is the backward of every row
// gather of the embedding models (word2vec, paragraph vectors, GloVe): the
// gradient of table[idx] is zeros_like(table) with the output's gradient rows
// added at idx.
//
// Why atomics. The TPU kernel is right about duplicate indices only because
// the Pallas grid runs in order on one core: each update row reads its table
// row into VMEM, adds and writes it back, one after the other. On the H100
// blocks run in any order on 132 SMs, so two update rows of one table row
// would race. Here every add is an atomic whose result is unused, which the
// compiler emits as a reduction (RED) that L2 carries out: duplicates
// accumulate, in an order that changes from run to run (so f32 sums differ
// from a serial sum in the last bits; the callers' tolerances say so).
//
// Indices outside [0, R) are skipped, as XLA's scatter drops them (the
// Pallas kernel is undefined there). There is no device-side assert.
//
// Bound on an H100 SXM (3.35 TB/s HBM): bytes. Each update row and index is
// read once and each touched table row is read and written once, so for N
// rows of D elements over U distinct rows the least traffic is
//   N*D*size + N*sizeof(index) + 2*U*D*size.
// At the word2vec bench's syn1 shape (N = 622,592 rows of 128 f32 into
// 9,999 rows) that is about 324 MB, 0.097 ms. The work is a handful of adds
// per byte, far below the card's operations-to-bytes ratio.
//
// Design. One warp per update row, 8 warps a block, a grid-stride loop over
// the rows. The warp's lanes load the row's index once (one broadcast), skip
// the row if it is out of range, and stride over the columns: lane l adds
// columns l, l + 32, ... with coalesced loads of the update row and one
// atomic each (f32), or one paired __nv_bfloat162 atomic per two columns
// (bf16, D even, the table row 4-byte aligned). Updates may come with a row
// stride; columns must be unit-stride in both tensors.
// At D = 1 (f32; the GloVe biases) a warp a row would leave 31 lanes idle:
// scatter_add_f32_d1_kernel gives each thread one update instead, and a
// warp first sums the updates that share an index (`__match_any_sync`
// groups them, a tree of shuffles sums each group) so that it issues one
// RED per distinct index. The order of the adds changes as the atomics'
// does: integer-valued sums stay exact, others stay within the any-order
// bound.
// What it does not do yet: rows that many updates share (the Huffman root
// takes every pair of a word2vec step) serialise their atomics in L2 at
// D > 1; pre-aggregating equal indices there, or a sort-and-segment pass, is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr long long kMaxBlocks = 1 << 20;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
scatter_add_f32_kernel(float* __restrict__ table,
                       const Index* __restrict__ idx,
                       const float* __restrict__ upd, long long R,
                       long long N, int D, long long table_s,
                       long long upd_s) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long n = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       n < N; n += stride) {
    const long long r = (long long)__ldg(idx + n);
    if (r < 0 || r >= R) continue;
    float* dst = table + r * table_s;
    const float* src = upd + n * upd_s;
    for (int c = lane; c < D; c += 32) atomicAdd(dst + c, __ldg(src + c));
  }
}

// The sum of x over the lanes whose `peers` mask (from __match_any_sync)
// holds this lane, in the group's lowest lane (other lanes: partial sums).
// Each round, every lane adds the value of the next peer still in play,
// and the peers at odd positions drop out: log2 of the largest group
// rounds, all in uniform control flow. Every lane of the warp calls it.
__device__ __forceinline__ float sum_peers(unsigned peers, float x) {
  const int lane = threadIdx.x & 31;
  int pos = __popc(peers & ((1u << lane) - 1u));  // rank in the group
  peers &= ~((2u << lane) - 1u);                  // peers above this lane
  while (__any_sync(0xffffffffu, peers != 0)) {
    const int next = __ffs(peers);  // 1 + the next peer's lane, or 0
    const float y = __shfl_sync(0xffffffffu, x, next ? next - 1 : lane);
    if (next) x += y;
    peers &= ~__ballot_sync(0xffffffffu, pos & 1);
    pos >>= 1;
  }
  return x;
}

// D = 1: one thread per update, equal indices summed in the warp first.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
scatter_add_f32_d1_kernel(float* __restrict__ table,
                          const Index* __restrict__ idx,
                          const float* __restrict__ upd, long long R,
                          long long N, long long table_s, long long upd_s) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  // a warp's lanes take updates base .. base + 31 and loop together
  for (long long base = (long long)blockIdx.x * kThreads + threadIdx.x - lane;
       base < N; base += stride) {
    const long long n = base + lane;
    long long r = n < N ? (long long)__ldg(idx + n) : -1;
    if (r >= R) r = -1;  // out of range: skipped, like r < 0
    const float x = r >= 0 ? __ldg(upd + n * upd_s) : 0.f;
    const unsigned peers =
        __match_any_sync(0xffffffffu, (unsigned long long)r);
    const float sum = sum_peers(peers, x);
    if (r >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(table + r * table_s, sum);
  }
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
scatter_add_bf16_kernel(bf16* __restrict__ table,
                        const Index* __restrict__ idx,
                        const bf16* __restrict__ upd, long long R,
                        long long N, int D, long long table_s,
                        long long upd_s) {
  const int lane = threadIdx.x & 31;
  const int pairs = D >> 1;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long n = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       n < N; n += stride) {
    const long long r = (long long)__ldg(idx + n);
    if (r < 0 || r >= R) continue;
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(table + r * table_s);
    const bf16* src = upd + n * upd_s;
    for (int p = lane; p < pairs; p += 32) {
      __nv_bfloat162 v;
      v.x = src[2 * p];
      v.y = src[2 * p + 1];
      atomicAdd(dst + p, v);
    }
  }
}

template <typename Index>
int launch(void* table, const void* idx, const void* upd, long long R,
           long long N, int D, long long table_s, long long upd_s, int dtype,
           cudaStream_t st) {
  long long blocks = (N + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Index* ix = static_cast<const Index*>(idx);
  if (dtype == 0 && D == 1) {
    long long d1_blocks = (N + kThreads - 1) / kThreads;
    if (d1_blocks > kMaxBlocks) d1_blocks = kMaxBlocks;
    scatter_add_f32_d1_kernel<Index><<<(unsigned)d1_blocks, kThreads, 0, st>>>(
        static_cast<float*>(table), ix, static_cast<const float*>(upd), R, N,
        table_s, upd_s);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    scatter_add_f32_kernel<Index><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<float*>(table), ix, static_cast<const float*>(upd), R, N,
        D, table_s, upd_s);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    if (D % 2 != 0 || table_s % 2 != 0) return (int)cudaErrorInvalidValue;
    scatter_add_bf16_kernel<Index><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<bf16*>(table), ix, static_cast<const bf16*>(upd), R, N, D,
        table_s, upd_s);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// table [R, D] (row stride table_s, unit column stride) += upd [N, D] (row
// stride upd_s) at rows idx [N] (int32, or int64 when idx64); dtype 0 is
// f32, 1 bf16 (D and table_s even). Returns the launch's CUDA error code.
extern "C" int scatter_add_rows(void* table, const void* idx, const void* upd,
                                long long R, long long N, int D,
                                long long table_s, long long upd_s, int idx64,
                                int dtype, void* stream) {
  if (R < 1 || N < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch<long long>(table, idx, upd, R, N, D, table_s, upd_s, dtype,
                             st);
  return launch<int>(table, idx, upd, R, N, D, table_s, upd_s, dtype, st);
}
