// The Gather phase of the composed DC path on Hopper: fold the gather-order
// [NE] edge-value stream into each destination partition's accumulators.
//
// Replaces the Pallas kernel repro.kernels.segment_combine.segment_combine
// (src/repro/kernels/segment_combine.py:122).  Python side:
// repro_torch/kernels/segment_combine.py (segment_combine_cuda).
//
// What bounds it on this card: bytes.  Every edge of a live tile reads its
// value (4 B), validity (1 B) and destination offset (4 B) once; each
// partition's q accumulators and touched flags are written once (5 B a
// vertex).  The work is one shared-memory atomic per valid edge.
//
// Design: the same as fused_dc.cu, reading a materialized edge stream instead
// of gathering from a table.  Edge tiles are destination-major, so the tiles
// of destination partition p are [part_tile_off[p], part_tile_off[p+1]) and
// their edges one contiguous range.  One thread block owns one destination
// partition: it sets that partition's q accumulators to the identity in
// shared memory (the TPU kernel's reset at tile_first), folds its tiles into
// them with shared-memory atomics, and writes its slice of acc and touched
// once.  Each warp takes one tile at a time and skips it whole when its
// source partition is inactive (part_active[tile_src_part[t]] == 0, the
// paper's 2-level active list), so a skipped tile costs no edge bytes.  No
// global atomics, and no block reads another block's output.  A partition
// wider than `chunk` segments is split over several blocks; each walks the
// partition's tiles and keeps the edges that land in its slice.  A partition
// with no tiles is written as the identity, untouched.
//
// The TPU kernel folds float add by a one-hot matmul, so one non-finite
// message there turns its whole partition into NaN; this kernel folds each
// edge into its own destination only.  The two agree on finite payloads,
// which is what the parity tests use.
//
// Precondition, checked on the host once per layout (GatherKernel):
// part_tile_off is the destination-partition structure of the tiles.  A tile
// whose source partition lies outside [0, k), and an edge whose dst_local
// lies outside [0, q), fold nothing.
#include "fold.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <int M, typename T>
__global__ void __launch_bounds__(kThreads) segment_combine_kernel(
    const T* __restrict__ vals, const uint8_t* __restrict__ valid,
    const int* __restrict__ dst_local, const int* __restrict__ tile_src_part,
    const long long* __restrict__ part_tile_off,
    const uint8_t* __restrict__ part_active, int k, int q, int edge_tile,
    int chunk, int n_chunks, T* __restrict__ acc,
    uint8_t* __restrict__ touched) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_acc = reinterpret_cast<T*>(smem);
  uint8_t* s_touched = smem + sizeof(T) * chunk;

  const int p = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const int lo = c * chunk;
  const int width = min(chunk, q - lo);

  for (int i = threadIdx.x; i < width; i += kThreads) {
    s_acc[i] = identity<M, T>();
    s_touched[i] = 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long t1 = part_tile_off[p + 1];
  for (long long t = part_tile_off[p] + warp; t < t1; t += kWarps) {
    const int sp = tile_src_part[t];                    // warp-uniform
    if (sp < 0 || sp >= k || !part_active[sp]) continue;
    const long long e0 = t * edge_tile;
    for (int i = lane; i < edge_tile; i += 32) {
      const long long e = e0 + i;
      const uint8_t ok = valid[e];
      const int local = dst_local[e] - lo;
      if (!ok || local < 0 || local >= width) continue;
      fold_into<M, T>(&s_acc[local], vals[e]);
      s_touched[local] = 1;
    }
  }
  __syncthreads();

  const long long base = (long long)p * q + lo;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    acc[base + i] = s_acc[i];
    touched[base + i] = s_touched[i];
  }
}

}  // namespace

// Returns 0 or the cudaError_t of the launch.  Pointers are device pointers;
// acc and touched hold k*q entries, part_tile_off k+1.
extern "C" int segment_combine(const void* vals, const void* valid,
                               const void* dst_local,
                               const void* tile_src_part,
                               const void* part_tile_off,
                               const void* part_active, int k, int q,
                               int edge_tile, int chunk, int monoid, int dtype,
                               void* acc, void* touched, void* stream) {
  if (k <= 0 || q <= 0 || edge_tile <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (q + chunk - 1) / chunk;
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    const size_t smem = (sizeof(T) + 1) * (size_t)chunk;
    cudaError_t err = cudaFuncSetAttribute(
        segment_combine_kernel<C::monoid, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    segment_combine_kernel<C::monoid, T><<<k * n_chunks, kThreads, smem, s>>>(
        static_cast<const T*>(vals), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(dst_local),
        static_cast<const int*>(tile_src_part),
        static_cast<const long long*>(part_tile_off),
        static_cast<const uint8_t*>(part_active), k, q, edge_tile, chunk,
        n_chunks, static_cast<T*>(acc), static_cast<uint8_t*>(touched));
    return cudaGetLastError();
  });
}

extern "C" const char* segment_combine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
