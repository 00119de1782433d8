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
// Design. f32 at D > 1 (the word2vec and GloVe tables): equal indices are
// summed on chip before anything reaches L2. scatter_add_f32_sorted_kernel
// gives a block of 256 threads a contiguous chunk of 256 kItems
// updates. The block loads the chunk's indices (an index outside [0, R)
// becomes the key R, which sorts last and is dropped), sorts the (index,
// position) pairs in shared memory (cub::BlockRadixSort over the bits of
// R, stable, so each index's updates stay in the order of n), and cuts the
// sorted chunk into 8 equal ranges, one a warp. A warp walks its range in
// order with its lanes across the columns (a float4 a lane where D, the
// strides and the bases are 16-byte aligned, else a float), adds each
// update row into registers (kUnroll rows loaded ahead, coalesced), and
// when the index changes issues one RED per column group: atomicAdd of a
// float4, which sm_90 carries out as one vector RED (REDG.E.ADD.F32x4), or
// of a float. So a chunk costs one RED per column group for each distinct
// index of each warp's range, where the first version (one warp per update
// row) issued one scalar RED per element: at syn1 the Huffman root, which
// every pair's path passes, took half of the 622,592 rows' REDs on the
// same 128 addresses, one after another in L2.
//
// The order of the adds: within a warp's range in the order of n, then
// the REDs in any order. Integer-valued sums stay exact, others stay
// within the any-order bound 2 n u S.
//
// The chunk is the largest of 1,024, 512 and 256 updates that still gives
// the grid two blocks an SM (measured on the H100 at the word2vec step's
// shapes: chunks of 1,024 at syn1, 512 at syn1neg, 256 at syn0; PERF.md).
// The first version (one warp per update row, one scalar RED per element)
// is gone: it ran syn1 11.7x slower (PERF.md).
// The sort's keys are 32-bit: tables of 2^32 - 1 rows or more are refused.
//
// At D = 1 (f32; the GloVe biases) a warp a row would leave 31 lanes idle:
// scatter_add_f32_d1_kernel gives each thread one update instead, and a
// warp first sums the updates that share an index (`__match_any_sync`
// groups them, a tree of shuffles sums each group) so that it issues one
// RED per distinct index.
//
// bf16 (scatter_add_bf16_kernel): one warp per update row, lane l adds the
// column pairs l, l + 32, ... with one __nv_bfloat162 atomic each (D even,
// the table row 4-byte aligned). Updates may come with a row stride;
// columns must be unit-stride in both tensors.
//
// What it does not do yet: a group that spans several warps' ranges costs
// one RED a warp (merging them in shared memory first is later work), and
// at D < 128 a warp's lanes past the row's last column group idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include <cub/block/block_radix_sort.cuh>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr long long kMaxBlocks = 1 << 20;

// ------------------------------------------------ f32, D > 1: sorted chunks

constexpr int kUnroll = 4;  // update rows a lane loads ahead

__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
// one RED: a float4 is one vector RED on sm_90
__device__ __forceinline__ void red(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void red(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ float4 load(const float* p, float4) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float load(const float* p, float) {
  return __ldg(p);
}

// One warp's range [begin, end) of the sorted chunk, at the columns
// (col, col + 1, ... of V) of this lane: the update rows of each index run
// summed in order, one RED a run.
template <typename V>
__device__ __forceinline__ void walk_range(float* __restrict__ table,
                                           const float* __restrict__ upd,
                                           const unsigned* keys,
                                           const int* pos, int begin,
                                           int end, int col, long long base,
                                           long long table_s,
                                           long long upd_s) {
  unsigned cur = keys[begin];
  V acc = zero_of(V());
  for (int rk = begin; rk < end; rk += kUnroll) {
    V v[kUnroll];
    unsigned k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = rk + u < end ? rk + u : begin;
      k[u] = keys[q];
      v[u] = load(upd + (base + pos[q]) * upd_s + col, V());
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (rk + u >= end) break;
      if (k[u] != cur) {
        red(table + (long long)cur * table_s + col, acc);
        acc = zero_of(V());
        cur = k[u];
      }
      add_to(acc, v[u]);
    }
  }
  red(table + (long long)cur * table_s + col, acc);
}

// A chunk of kThreads * kItems updates a block: sort the chunk's
// (index, position) pairs by index, then each warp sums its range of the
// sorted chunk (walk_range). key_bits: the bits of R (the key of an
// out-of-range update). vec4: D, both row strides and both bases allow
// float4 columns.
template <typename Index, int kItems>
__global__ void __launch_bounds__(kThreads)
scatter_add_f32_sorted_kernel(float* __restrict__ table,
                              const Index* __restrict__ idx,
                              const float* __restrict__ upd, long long R,
                              long long N, int D, long long table_s,
                              long long upd_s, int key_bits, int vec4) {
  constexpr int kChunk = kThreads * kItems;
  typedef cub::BlockRadixSort<unsigned, kThreads, kItems, int> Sort;
  __shared__ typename Sort::TempStorage sort_tmp;
  __shared__ unsigned keys[kChunk];
  __shared__ int pos[kChunk];
  __shared__ int n_valid;
  if (threadIdx.x == 0) n_valid = 0;
  const long long base = (long long)blockIdx.x * kChunk;
  unsigned key[kItems];
  int at[kItems];
  int valid = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    // blocked: thread t holds positions t * kItems + i, so the stable sort
    // keeps each index's positions in the order of n
    at[i] = threadIdx.x * kItems + i;
    const long long n = base + at[i];
    const long long r = n < N ? (long long)__ldg(idx + n) : -1;
    const bool in = r >= 0 && r < R;
    key[i] = in ? (unsigned)r : (unsigned)R;
    valid += in;
  }
  __syncthreads();  // n_valid is 0
  if (valid) atomicAdd(&n_valid, valid);
  Sort(sort_tmp).Sort(key, at, 0, key_bits);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    keys[threadIdx.x * kItems + i] = key[i];
    pos[threadIdx.x * kItems + i] = at[i];
  }
  __syncthreads();
  // the in-range updates sort first: ranks [0, n_valid)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kPer = kChunk / kWarps;
  const int begin = warp * kPer;
  const int end = begin + kPer < n_valid ? begin + kPer : n_valid;
  if (begin >= end) return;
  if (vec4) {
    for (int c = 4 * lane; c < D; c += 128)
      walk_range<float4>(table, upd, keys, pos, begin, end, c, base, table_s,
                         upd_s);
  } else {
    for (int c = lane; c < D; c += 32)
      walk_range<float>(table, upd, keys, pos, begin, end, c, base, table_s,
                        upd_s);
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

// The sorted body with kItems updates a thread (chunks of 256 kItems).
template <typename Index, int kItems>
int launch_sorted(float* table, const Index* idx, const float* upd,
                  long long R, long long N, int D, long long table_s,
                  long long upd_s, cudaStream_t st) {
  constexpr long long kChunk = kThreads * kItems;
  int key_bits = 1;  // R itself (the out-of-range key) must fit
  while (key_bits < 32 && (1LL << key_bits) <= R) ++key_bits;
  const int vec4 = D % 4 == 0 && table_s % 4 == 0 && upd_s % 4 == 0 &&
                   ((uintptr_t)table | (uintptr_t)upd) % 16 == 0;
  scatter_add_f32_sorted_kernel<Index, kItems>
      <<<(unsigned)((N + kChunk - 1) / kChunk), kThreads, 0, st>>>(
          table, idx, upd, R, N, D, table_s, upd_s, key_bits, vec4);
  return (int)cudaGetLastError();
}

// The f32 D > 1 launch: the most updates a thread (4, 2 or 1) that still
// gives the grid two blocks an SM.
template <typename Index>
int launch_f32(float* table, const Index* idx, const float* upd, long long R,
               long long N, int D, long long table_s, long long upd_s,
               cudaStream_t st) {
  if (R >= 0xffffffffLL || (N + kThreads - 1) / kThreads >= INT_MAX)
    return (int)cudaErrorInvalidValue;
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
  if (N >= 2LL * sms * kThreads * 4)
    return launch_sorted<Index, 4>(table, idx, upd, R, N, D, table_s, upd_s,
                                   st);
  if (N >= 2LL * sms * kThreads * 2)
    return launch_sorted<Index, 2>(table, idx, upd, R, N, D, table_s, upd_s,
                                   st);
  return launch_sorted<Index, 1>(table, idx, upd, R, N, D, table_s, upd_s,
                                 st);
}

template <typename Index>
int launch(void* table, const void* idx, const void* upd, long long R,
           long long N, int D, long long table_s, long long upd_s, int dtype,
           cudaStream_t st) {
  const Index* ix = static_cast<const Index*>(idx);
  if (dtype == 0 && D == 1) {
    long long blocks = (N + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    scatter_add_f32_d1_kernel<Index><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<float*>(table), ix, static_cast<const float*>(upd), R, N,
        table_s, upd_s);
    return (int)cudaGetLastError();
  }
  if (dtype == 0)
    return launch_f32<Index>(static_cast<float*>(table), ix,
                             static_cast<const float*>(upd), R, N, D, table_s,
                             upd_s, st);
  if (dtype == 1) {
    if (D % 2 != 0 || table_s % 2 != 0) return (int)cudaErrorInvalidValue;
    long long blocks = (N + kWarps - 1) / kWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
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
