// Partition-centric SpMV on Hopper: y[dst] += w * x[src] over the gather-order
// edges, f32.
//
// Replaces the Pallas kernel repro.kernels.spmv_block.spmv_block
// (src/repro/kernels/spmv_block.py:69).  Python side:
// repro_torch/kernels/spmv_block.py (spmv_block_cuda).
//
// What bounds it on this card: bytes.  Every edge reads its source offset,
// destination offset (4 B each), validity (1 B) and, weighted, its weight
// (4 B) once; x (4 B a vertex) is read at random but fits the 50 MB L2, and
// y is written once.  The work is one multiply and one shared-memory atomic
// add per valid edge.
//
// Design: the block structure of segment_combine.cu.  One thread block owns
// one destination partition's q outputs in shared memory (zeroed at the
// start: the TPU kernel's reset at tile_first), each warp takes one of the
// partition's edge tiles at a time, and each lane folds a valid edge's
// x[tile_src_part[t] * q + src_local] (times w) into its destination.  The
// block writes its slice of y once; no global atomics.  The TPU kernel keeps
// the source partition's x row in VMEM per tile; here x is read through L2.
// A partition wider than `chunk` is split over several blocks, and a
// partition with no tiles is written as 0.
//
// The TPU kernel sums by a one-hot matmul, so one non-finite product there
// turns its whole partition into NaN; this kernel adds each product into its
// own destination only.  The two agree on finite payloads.
//
// Precondition, checked on the host once per layout (SpmvKernel):
// part_tile_off is the destination-partition structure of the tiles.  A tile
// whose source partition lies outside [0, k), and an edge whose src_local or
// dst_local lies outside [0, q), add nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <bool WEIGHTED>
__global__ void __launch_bounds__(kThreads) spmv_block_kernel(
    const float* __restrict__ x, const int* __restrict__ src_local,
    const int* __restrict__ dst_local, const uint8_t* __restrict__ valid,
    const float* __restrict__ w, const int* __restrict__ tile_src_part,
    const long long* __restrict__ part_tile_off, int k, int q, int edge_tile,
    int chunk, int n_chunks, float* __restrict__ y) {
  extern __shared__ __align__(16) float s_y[];

  const int p = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const int lo = c * chunk;
  const int width = min(chunk, q - lo);

  for (int i = threadIdx.x; i < width; i += kThreads) s_y[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long t1 = part_tile_off[p + 1];
  for (long long t = part_tile_off[p] + warp; t < t1; t += kWarps) {
    const int sp = tile_src_part[t];                    // warp-uniform
    if (sp < 0 || sp >= k) continue;
    const long long e0 = t * edge_tile;
    const long long xbase = (long long)sp * q;
    for (int i = lane; i < edge_tile; i += 32) {
      const long long e = e0 + i;
      const uint8_t ok = valid[e];
      const int local = dst_local[e] - lo;
      const int src = src_local[e];
      if (!ok || local < 0 || local >= width || src < 0 || src >= q) continue;
      float v = x[xbase + src];
      if constexpr (WEIGHTED) v = v * w[e];
      atomicAdd(&s_y[local], v);
    }
  }
  __syncthreads();

  const long long base = (long long)p * q + lo;
  for (int i = threadIdx.x; i < width; i += kThreads) y[base + i] = s_y[i];
}

template <bool WEIGHTED>
cudaError_t launch(const void* x, const void* src_local, const void* dst_local,
                   const void* valid, const void* w, const void* tile_src_part,
                   const void* part_tile_off, int k, int q, int edge_tile,
                   int chunk, void* y, cudaStream_t stream) {
  const int n_chunks = (q + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * (size_t)chunk;
  cudaError_t err = cudaFuncSetAttribute(
      spmv_block_kernel<WEIGHTED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  spmv_block_kernel<WEIGHTED><<<k * n_chunks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(src_local),
      static_cast<const int*>(dst_local), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(w), static_cast<const int*>(tile_src_part),
      static_cast<const long long*>(part_tile_off), k, q, edge_tile, chunk,
      n_chunks, static_cast<float*>(y));
  return cudaGetLastError();
}

}  // namespace

// Returns 0 or the cudaError_t of the launch.  Pointers are device pointers;
// x and y hold k*q floats, part_tile_off k+1 entries; w is read only when
// weighted is nonzero.
extern "C" int spmv_block(const void* x, const void* src_local,
                          const void* dst_local, const void* valid,
                          const void* w, const void* tile_src_part,
                          const void* part_tile_off, int k, int q,
                          int edge_tile, int chunk, int weighted, void* y,
                          void* stream) {
  if (k <= 0 || q <= 0 || edge_tile <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weighted)
    return (int)launch<true>(x, src_local, dst_local, valid, w, tile_src_part,
                             part_tile_off, k, q, edge_tile, chunk, y, s);
  return (int)launch<false>(x, src_local, dst_local, valid, w, tile_src_part,
                            part_tile_off, k, q, edge_tile, chunk, y, s);
}

extern "C" const char* spmv_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
