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
// What bounds it on this card: bytes.  Each message is read once (9 bytes)
// and each segment written once (5 bytes); the work is one atomic per valid
// message.
//
// Design: the engine's SC stream is in CSR order, not sorted by destination,
// so a message's segment is anywhere in [0, num_segments).  One thread per
// message folds it with a global atomic into acc and sets touched; an init
// kernel on the same stream first fills acc with the identity and clears
// touched.  Invalid messages and ids outside [0, num_segments) contribute
// nothing.
#include "fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <int M, typename T>
__global__ void init_kernel(T* __restrict__ acc, uint8_t* __restrict__ touched,
                            long long num_segments) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < num_segments; i += (long long)gridDim.x * kThreads) {
    acc[i] = identity<M, T>();
    touched[i] = 0;
  }
}

template <int M, typename T>
__global__ void fold_kernel(const T* __restrict__ vals,
                            const uint8_t* __restrict__ valid,
                            const int* __restrict__ ids, long long n,
                            long long num_segments, T* __restrict__ acc,
                            uint8_t* __restrict__ touched) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const uint8_t ok = valid[i];
    const int id = ids[i];
    if (!ok || id < 0 || id >= num_segments) continue;
    fold_into<M, T>(&acc[id], vals[i]);
    touched[id] = 1;
  }
}

}  // namespace

// Returns 0 or the cudaError_t of the launches.  Pointers are device pointers.
extern "C" int segment_fold(const void* vals, const void* valid,
                            const void* ids, long long n,
                            long long num_segments, int monoid, int dtype,
                            void* acc, void* touched, void* stream) {
  if (n < 0 || num_segments <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    init_kernel<C::monoid, T><<<blocks_for(num_segments), kThreads, 0, s>>>(
        static_cast<T*>(acc), static_cast<uint8_t*>(touched), num_segments);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n == 0) return err;
    fold_kernel<C::monoid, T><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const T*>(vals), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(ids), n, num_segments, static_cast<T*>(acc),
        static_cast<uint8_t*>(touched));
    return cudaGetLastError();
  });
}

extern "C" const char* segment_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
