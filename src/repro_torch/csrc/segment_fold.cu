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
// Design: the stream fold of stream_fold.cuh (one cooperative launch; a
// shared-memory regime up to kSharedMaxSegments<T> segments, global atomics
// past it; warps combine runs of equal adjacent ids first), reading its
// messages from the three arrays.  Invalid messages and ids outside
// [0, num_segments) contribute nothing.
#include "stream_fold.cuh"

namespace {

// Message i is (ids[i], vals[i]) when valid[i] and the id is in range.
template <typename T>
struct Messages {
  const T* vals;
  const uint8_t* valid;
  const int* ids;

  __device__ __forceinline__ void load(long long i, long long ns, int& key,
                                       T& v) const {
    const int id = ids[i];
    const T val = vals[i];
    if (valid[i] && id >= 0 && id < ns) {
      key = id;
      v = val;
    }
  }
};

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
  const cudaError_t bad =
      stream_fold::check_args(n, num_segments, device, acc, touched);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    const Messages<T> src{static_cast<const T*>(vals),
                          static_cast<const uint8_t*>(valid),
                          static_cast<const int*>(ids)};
    return stream_fold::launch<C::monoid, T>(src, n, num_segments, acc,
                                             touched, device, s);
  });
}

extern "C" const char* segment_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
