// The segmented monoid fold of an unstructured message stream into
// acc[num_segments] and touched[num_segments], on Hopper: the skeleton that
// segment_fold.cu (messages read from arrays) and fused_stream.cu (messages
// gathered from a table) share, each giving it a message source.
//
// Design: one launch per call, a cooperative grid (every block resident, so
// that a grid barrier can order the identity fill before the folds), in one
// of two regimes chosen by num_segments:
//
//   * few segments (at most kSharedMaxSegments<T>, whose acc and touched
//     flags, 5 B a segment (9 B for long long), fit kSharedBudget bytes of
//     one block's shared memory: 40,960 segments, 22,752 for long long):
//     each block fills its share of the global outputs with 16-byte stores,
//     sets up a private acc and touched in shared memory, folds a contiguous
//     slice of the stream into them, and after the grid barrier merges each
//     segment it touched into the global acc with one atomic.  So equal ids
//     meet in the block's shared memory, not all at one global address.
//   * many segments: the blocks fill the global outputs with 16-byte stores,
//     meet at the grid barrier, and fold the stream with global atomics.
//
// In both, a warp folds 32 consecutive messages at a time and first combines
// each run of equal ids in adjacent lanes (a segmented reduction by shuffles),
// so a sorted stream costs one atomic per run and per 32 messages, not one
// per message.  Equal ids that are not adjacent fold separately.
//
// A message source Src is a trivially copyable struct, passed to the kernel
// by value, with
//   __device__ void load(long long i, long long ns, int& key, T& v) const;
// which sets key (in [0, ns)) and v for message i when it contributes, and
// leaves them (-1, the identity) when it does not.
#pragma once

#include <cooperative_groups.h>

#include <cstring>

#include "fold.cuh"

namespace stream_fold {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // 32-message groups a lane loads at once
constexpr int kStep = 32 * kUnroll;    // messages a warp takes per step
constexpr long long kMinBlockMessages = 8192;

__host__ __device__ constexpr long long round16(long long b) {
  return (b + 15) / 16 * 16;
}

// Shared-memory bytes of the few-segments regime: acc, then touched.
template <typename T>
__host__ __device__ constexpr long long shared_bytes(long long ns) {
  return round16(sizeof(T) * ns) + round16(ns);
}

// The few-segments regime's shared memory, and the most segments of T that
// fit it (a multiple of 16): 40,960 four-byte and 22,752 eight-byte ones.
constexpr long long kSharedBudget = 204800;
template <typename T>
constexpr long long kSharedMaxSegments =
    kSharedBudget / (sizeof(T) + 1) / 16 * 16;
static_assert(kSharedMaxSegments<float> == 40960 &&
                  shared_bytes<float>(kSharedMaxSegments<float>) <=
                      kSharedBudget &&
                  shared_bytes<long long>(kSharedMaxSegments<long long>) <=
                      kSharedBudget &&
                  shared_bytes<long long>(kSharedMaxSegments<long long> +
                                          16) > kSharedBudget,
              "kSharedMaxSegments<T> is the widest slice the budget holds");

// Folds v into acc[key] (and sets touched[key]) for the head of each run of
// equal keys in adjacent lanes, with the run's values combined first.  Whole
// warp; key < 0 contributes nothing.
template <int M, typename T>
__device__ __forceinline__ void fold_runs(int key, T v, T* acc,
                                          uint8_t* touched) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(all, key, 1);
  const bool head = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(all, head);
  if (heads == all) {            // no two adjacent lanes share an id
    if (key >= 0) {
      fold_into<M, T>(&acc[key], v);
      touched[key] = 1;
    }
    return;
  }
  const unsigned later = heads & ~((2u << lane) - 1u);  // heads past lane
  const int end = later ? __ffs(later) - 2 : 31;        // last lane of run
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_down_sync(all, v, d);
    if (lane + d <= end) v = combine<M, T>(v, u);
  }
  if (head && key >= 0) {
    fold_into<M, T>(&acc[key], v);
    touched[key] = 1;
  }
}

// Folds messages [lo, hi) of src into (acc, touched): warp `warp` of `warps`
// takes steps of kStep consecutive messages.
template <int M, typename T, typename Src>
__device__ __forceinline__ void fold_range(const Src& src, long long lo,
                                           long long hi, long long ns,
                                           long long warp, long long warps,
                                           T* acc, uint8_t* touched) {
  const int lane = threadIdx.x & 31;
  for (long long b = lo + warp * kStep; b < hi; b += warps * kStep) {
    int key[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = b + u * 32 + lane;
      key[u] = -1;
      v[u] = identity<M, T>();
      if (i < hi) src.load(i, ns, key[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fold_runs<M, T>(key[u], v[u], acc, touched);
  }
}

// Fills acc[ns] with the identity and touched[ns] with 0 (both 16-byte
// aligned) in 16-byte stores, the tails by single elements; `stride`
// threads from thread `tid`.
template <int M, typename T>
__device__ __forceinline__ void fill(T* acc, uint8_t* touched, long long ns,
                                     long long tid, long long stride) {
  constexpr long long kPer = 16 / sizeof(T);   // identities a store holds
  const T ident = identity<M, T>();
  T row[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) row[j] = ident;
  uint4 iv;
  memcpy(&iv, row, sizeof(iv));
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long n4 = ns / kPer, n16 = ns / 16;
  uint4* a4 = reinterpret_cast<uint4*>(acc);
  uint4* t16 = reinterpret_cast<uint4*>(touched);
  for (long long i = tid; i < n4; i += stride) a4[i] = iv;
  for (long long i = tid; i < n16; i += stride) t16[i] = zero;
  for (long long i = kPer * n4 + tid; i < ns; i += stride) acc[i] = ident;
  for (long long i = 16 * n16 + tid; i < ns; i += stride) touched[i] = 0;
}

template <int M, typename T, bool SHARED, typename Src>
__global__ void __launch_bounds__(kThreads) stream_fold_kernel(
    Src src, long long n, long long ns, T* acc, uint8_t* touched) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / 32;
  fill<M, T>(acc, touched, ns, (long long)blockIdx.x * kThreads + threadIdx.x,
             (long long)gridDim.x * kThreads);
  if constexpr (SHARED) {
    T* s_acc = reinterpret_cast<T*>(smem);
    uint8_t* s_touched = smem + round16(sizeof(T) * ns);
    fill<M, T>(s_acc, s_touched, ns, threadIdx.x, kThreads);
    __syncthreads();
    const long long per = (n + gridDim.x - 1) / gridDim.x;
    const long long lo = min(n, blockIdx.x * per);
    fold_range<M, T>(src, lo, min(n, lo + per), ns, warp, kWarps, s_acc,
                     s_touched);
    __syncthreads();
    grid.sync();   // every block's fill of the global outputs is done
    for (long long i = threadIdx.x; i < ns; i += kThreads) {
      if (s_touched[i]) {
        fold_into<M, T>(&acc[i], s_acc[i]);
        touched[i] = 1;
      }
    }
  } else {
    grid.sync();   // every block's fill of the global outputs is done
    fold_range<M, T>(src, 0, n, ns, (long long)blockIdx.x * kWarps + warp,
                     (long long)gridDim.x * kWarps, acc, touched);
  }
}

template <int M, typename T, bool SHARED, typename Src>
cudaError_t launch_regime(const Src& src, long long n, long long ns, void* acc,
                          void* touched, int dev, cudaStream_t stream) {
  auto kernel = stream_fold_kernel<M, T, SHARED, Src>;
  const size_t smem = SHARED ? (size_t)shared_bytes<T>(ns) : 0;
  // Per host thread: (device, shared bytes) -> resident blocks on the card,
  // asked of the runtime only when either changes.
  thread_local int cached_dev = -1, cached_blocks = 0, cached_sms = 0;
  thread_local size_t cached_smem = 0;
  cudaError_t err;
  if (dev != cached_dev || smem != cached_smem) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = smem;
    cached_blocks = per_sm * sms;
    cached_sms = sms;
  }
  // One block per kMinBlockMessages messages, within what the card holds
  // at once; past few segments at least one block per SM for the fill.
  // Fewer blocks make the grid barrier cheaper, which the engine's small SC
  // streams feel most.
  const long long want = (n + kMinBlockMessages - 1) / kMinBlockMessages;
  const long long least = SHARED ? 1 : cached_sms;
  long long blocks = want < least ? least : want;
  if (blocks > cached_blocks) blocks = cached_blocks;
  Src s = src;
  T* a = static_cast<T*>(acc);
  uint8_t* t = static_cast<uint8_t*>(touched);
  void* args[] = {&s, &n, &ns, &a, &t};
  return cudaLaunchCooperativeKernel((const void*)kernel,
                                     dim3((unsigned)blocks), dim3(kThreads),
                                     args, smem, stream);
}

// Launches the fold of n messages of src into num_segments, in the regime
// num_segments selects.  acc and touched must be 16-byte aligned; dev is the
// current device's index.
template <int M, typename T, typename Src>
cudaError_t launch(const Src& src, long long n, long long num_segments,
                   void* acc, void* touched, int dev, cudaStream_t stream) {
  if (num_segments <= kSharedMaxSegments<T>)
    return launch_regime<M, T, true>(src, n, num_segments, acc, touched, dev,
                                     stream);
  return launch_regime<M, T, false>(src, n, num_segments, acc, touched, dev,
                                    stream);
}

// Checks the arguments every C entry of a stream fold shares.
inline cudaError_t check_args(long long n, long long num_segments, int device,
                              const void* acc, const void* touched) {
  if (n < 0 || num_segments <= 0 || device < 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(acc) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(touched) % 16 != 0)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace stream_fold
