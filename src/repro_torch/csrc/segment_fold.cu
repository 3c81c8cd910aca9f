// Segmented monoid fold of a message stream (vals, valid, ids) into
// acc[num_segments] and touched[num_segments], on Hopper.
//
// Replaces the Pallas kernels repro.kernels.fold_block.blocked_segment_fold
// (src/repro/kernels/fold_block.py:137) and
// repro.kernels.fold_two_level.two_level_segment_fold
// (src/repro/kernels/fold_two_level.py:158).  The 4096-segment cap between
// the two is a limit of TPU VMEM, not of this card, so one kernel serves both.
// Python side: repro_torch/kernels/fold_block.py (segment_fold_cuda).
//
// What bounds it on this card: bytes.  Each message is read once (9 bytes;
// 13 for the 8-byte min) and each segment written once (5 bytes; 9).  On
// the engine's SC streams (about 332K messages into n_pad + 1 = 4.19M
// segments at RMAT scale 22) the segments' 21 MB are most of it; on the
// tuner's sorted stream (67.3M messages into 6,145 segments) the messages
// are.
//
// Design: one launch per call, a cooperative grid (every block resident, so
// that a grid barrier can order the identity fill before the folds), in one
// of two regimes chosen here by num_segments:
//
//   * few segments (at most kSharedMaxSegments<T>, whose acc and touched
//     flags, 5 B a segment (9 B for long long), fit kSharedBudget bytes of
//     one block's shared memory: 40,960 segments, 22,752 for long long):
//     each block fills its
//     share of the global outputs with 16-byte stores, sets up a private
//     acc and touched in shared memory, folds a contiguous slice of the
//     stream into them, and after the grid barrier merges each segment it
//     touched into the global acc with one atomic.  So equal ids meet in
//     the block's shared memory, not all at one global address.
//   * many segments: the blocks fill the global outputs with 16-byte stores,
//     meet at the grid barrier, and fold the stream with global atomics.
//
// In both, a warp folds 32 consecutive messages at a time and first combines
// each run of equal ids in adjacent lanes (a segmented reduction by shuffles),
// so a sorted stream costs one atomic per run and per 32 messages, not one
// per message.  Equal ids that are not adjacent fold separately.
// Invalid messages and ids outside [0, num_segments) contribute nothing.
#include <cooperative_groups.h>

#include <cstring>

#include "fold.cuh"

namespace cg = cooperative_groups;

namespace {

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

// Folds messages [lo, hi) into (acc, touched): warp `warp` of `warps` takes
// steps of kStep consecutive messages.
template <int M, typename T>
__device__ __forceinline__ void fold_range(
    const T* __restrict__ vals, const uint8_t* __restrict__ valid,
    const int* __restrict__ ids, long long lo, long long hi, long long ns,
    long long warp, long long warps, T* acc, uint8_t* touched) {
  const int lane = threadIdx.x & 31;
  for (long long b = lo + warp * kStep; b < hi; b += warps * kStep) {
    int key[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = b + u * 32 + lane;
      key[u] = -1;
      v[u] = identity<M, T>();
      if (i < hi) {
        const int id = ids[i];
        const T val = vals[i];
        if (valid[i] && id >= 0 && id < ns) {
          key[u] = id;
          v[u] = val;
        }
      }
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

template <int M, typename T, bool SHARED>
__global__ void __launch_bounds__(kThreads) segment_fold_kernel(
    const T* __restrict__ vals, const uint8_t* __restrict__ valid,
    const int* __restrict__ ids, long long n, long long ns, T* acc,
    uint8_t* touched) {
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
    fold_range<M, T>(vals, valid, ids, lo, min(n, lo + per), ns, warp, kWarps,
                     s_acc, s_touched);
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
    fold_range<M, T>(vals, valid, ids, 0, n, ns,
                     (long long)blockIdx.x * kWarps + warp,
                     (long long)gridDim.x * kWarps, acc, touched);
  }
}

template <int M, typename T, bool SHARED>
cudaError_t launch(const void* vals, const void* valid, const void* ids,
                   long long n, long long ns, void* acc, void* touched,
                   int dev, cudaStream_t stream) {
  auto kernel = segment_fold_kernel<M, T, SHARED>;
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
  const T* v = static_cast<const T*>(vals);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  const int* id = static_cast<const int*>(ids);
  T* a = static_cast<T*>(acc);
  uint8_t* t = static_cast<uint8_t*>(touched);
  void* args[] = {&v, &ok, &id, &n, &ns, &a, &t};
  return cudaLaunchCooperativeKernel((const void*)kernel,
                                     dim3((unsigned)blocks), dim3(kThreads),
                                     args, smem, stream);
}

}  // namespace

// Returns 0 or the cudaError_t of the launch.  Pointers are device pointers
// on the current device, whose index is `device` (given by the caller, so
// that a call asks the runtime nothing but the launch); acc and touched must
// be 16-byte aligned (fresh allocations are).
extern "C" int segment_fold(const void* vals, const void* valid,
                            const void* ids, long long n,
                            long long num_segments, int monoid, int dtype,
                            void* acc, void* touched, int device,
                            void* stream) {
  if (n < 0 || num_segments <= 0 || device < 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(acc) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(touched) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    if (num_segments <= kSharedMaxSegments<T>)
      return launch<C::monoid, T, true>(vals, valid, ids, n, num_segments,
                                        acc, touched, device, s);
    return launch<C::monoid, T, false>(vals, valid, ids, n, num_segments, acc,
                                       touched, device, s);
  });
}

extern "C" const char* segment_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
