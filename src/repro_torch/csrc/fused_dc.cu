// The fused DC step on Hopper: gather each edge's source value from the vertex
// table and fold it into its destination vertex.
//
// Replaces the Pallas kernel repro.kernels.fused_step.fused_scatter_fold
// (src/repro/kernels/fused_step.py:192).  Python side:
// repro_torch/kernels/fused_step.py (fused_dc_cuda).
//
// What bounds it on this card: bytes.  Every edge streams idx, edge_valid and
// dst (and w for SSSP) from device memory once, 9 (13) bytes, against a few
// integer operations and one shared-memory atomic.  The gathered table of
// n_pad + 1 four-byte values (about 17 MB at RMAT scale 22) and its validity
// bytes fit the 50 MB L2, so the random gathers mostly hit L2.
//
// Design: the gather-order edges are grouped by destination partition
// (Layout.blk_off), so one thread block owns one destination partition.  It
// keeps that partition's q accumulators and touched flags in shared memory,
// folds the partition's contiguous edge range with shared-memory atomics,
// and writes its slice of acc and touched once.  No block reads another
// block's output and nothing folds through global atomics: the paper's lock-
// and atomic-free partition-centric gather, one partition in one SM's
// private memory.  The TPU kernel's sequential (bucket x edge-tile) grid is
// not carried over.  A partition wider than `chunk` segments is split over
// several blocks; each reads the partition's whole edge range and keeps the
// edges that land in its slice.
//
// Precondition, checked on the host once per layout (FusedDCKernel): every
// valid edge in partition p's range has p*q <= dst < (p+1)*q.  Segments at or
// above k*q (the engines' sentinel n_pad) receive nothing: identity, untouched.
#include "fold.cuh"

namespace {

constexpr int kThreads = 1024;
enum { EDGE_NONE = 0, EDGE_ADD_WEIGHT = 1 };

template <int M, typename T, bool WEIGHT>
__global__ void __launch_bounds__(kThreads) fused_dc_kernel(
    const T* __restrict__ table, const uint8_t* __restrict__ table_valid,
    long long table_len, const int* __restrict__ idx,
    const uint8_t* __restrict__ edge_valid, const int* __restrict__ dst,
    const float* __restrict__ w, const long long* __restrict__ part_off,
    int q, int chunk, int n_chunks, long long num_segments,
    T* __restrict__ acc, uint8_t* __restrict__ touched) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_acc = reinterpret_cast<T*>(smem);
  uint8_t* s_touched = smem + sizeof(T) * chunk;

  const int p = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const long long lo = (long long)p * q + (long long)c * chunk;
  const int width = min(chunk, q - c * chunk);

  for (int i = threadIdx.x; i < width; i += kThreads) {
    s_acc[i] = identity<M, T>();
    s_touched[i] = 0;
  }
  __syncthreads();

  const long long e1 = part_off[p + 1];
  for (long long e = part_off[p] + threadIdx.x; e < e1; e += kThreads) {
    // the three edge streams load together; the table loads after them
    const uint8_t ev = edge_valid[e];
    const long long local = (long long)dst[e] - lo;
    long long s = idx[e];
    s = s < 0 ? 0 : (s >= table_len ? table_len - 1 : s);
    if (!ev || local < 0 || local >= width || !table_valid[s]) continue;
    T v = table[s];
    if constexpr (WEIGHT) v = v + w[e];
    fold_into<M, T>(&s_acc[local], v);
    s_touched[local] = 1;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < width; i += kThreads) {
    acc[lo + i] = s_acc[i];
    touched[lo + i] = s_touched[i];
  }
  if (blockIdx.x == 0) {
    const long long tail = (long long)(gridDim.x / n_chunks) * q;
    for (long long i = tail + threadIdx.x; i < num_segments; i += kThreads) {
      acc[i] = identity<M, T>();
      touched[i] = 0;
    }
  }
}

template <int M, typename T, bool WEIGHT>
cudaError_t launch(const void* table, const void* table_valid,
                   long long table_len, const void* idx,
                   const void* edge_valid, const void* dst, const void* w,
                   const void* part_off, int k, int q, int chunk,
                   long long num_segments, void* acc, void* touched,
                   cudaStream_t stream) {
  const int n_chunks = (q + chunk - 1) / chunk;
  const size_t smem = (sizeof(T) + 1) * (size_t)chunk;
  cudaError_t err = cudaFuncSetAttribute(
      fused_dc_kernel<M, T, WEIGHT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_dc_kernel<M, T, WEIGHT><<<k * n_chunks, kThreads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const uint8_t*>(table_valid),
      table_len, static_cast<const int*>(idx),
      static_cast<const uint8_t*>(edge_valid), static_cast<const int*>(dst),
      static_cast<const float*>(w), static_cast<const long long*>(part_off),
      q, chunk, n_chunks, num_segments, static_cast<T*>(acc),
      static_cast<uint8_t*>(touched));
  return cudaGetLastError();
}

}  // namespace

// Returns 0 or the cudaError_t of the launch.  Pointers are device pointers;
// w is read only when edge_fn is EDGE_ADD_WEIGHT (float tables only).
extern "C" int fused_dc(const void* table, const void* table_valid,
                        long long table_len, const void* idx,
                        const void* edge_valid, const void* dst,
                        const void* w, const void* part_off, int k, int q,
                        int chunk, long long num_segments, int monoid,
                        int dtype, int edge_fn, void* acc, void* touched,
                        void* stream) {
  if (k <= 0 || q <= 0 || chunk <= 0 || table_len <= 0 ||
      num_segments < (long long)k * q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    if (edge_fn == EDGE_ADD_WEIGHT) {
      if constexpr (std::is_same_v<T, float>)
        return launch<C::monoid, T, true>(table, table_valid, table_len, idx,
                                          edge_valid, dst, w, part_off, k, q,
                                          chunk, num_segments, acc, touched, s);
      else
        return cudaErrorInvalidValue;
    }
    if (edge_fn != EDGE_NONE) return cudaErrorInvalidValue;
    return launch<C::monoid, T, false>(table, table_valid, table_len, idx,
                                       edge_valid, dst, w, part_off, k, q,
                                       chunk, num_segments, acc, touched, s);
  });
}

extern "C" const char* fused_dc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
