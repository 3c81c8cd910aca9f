// Partition-centric SpMV on Hopper: y[dst] += w * x[src] over the gather-order
// edges, f32.
//
// Replaces the Pallas kernel repro.kernels.spmv_block.spmv_block
// (src/repro/kernels/spmv_block.py:69).  Python side:
// repro_torch/kernels/spmv_block.py (spmv_block_cuda).
//
// What bounds it on this card: by the bytes it must move, 0.27 ms at
// RMAT scale 22 (every edge reads its source offset, destination offset,
// 4 B each, validity, 1 B, and weighted its weight, 4 B, once; x and y add
// 8 B a vertex).  Two costs that bound leaves out hold it well above that:
//   * each x gather moves a 32-byte L2 sector for a 4-byte value, and the
//     edges of one (source, destination) partition block lie about 8 source
//     ids apart, so it is about one sector an edge (2.15 GB of L2 reads);
//   * a float atomic add to shared memory compiles to a compare-and-swap
//     loop on sm_90a (integer adds and min/max are single instructions), and
//     RMAT hubs draw up to a sixth of a partition's edges onto one address.
//     With one plain atomic per edge the warps queue on the hubs' addresses
//     and the partition with the largest hub sets the kernel's time.
//
// Design: one thread block owns one destination partition's q outputs in
// shared memory (zeroed at the start: the TPU kernel's reset at tile_first)
// and writes its slice of y once; no global atomics.  The partition's tiles
// stream through a ring of shared-memory stages (edge_stream.cuh): one
// producer warp keeps kStages stages of kStageEdges edges in flight with
// bulk asynchronous copies, skipping a tile whose source partition lies
// outside [0, k).  kConsumerWarps consumer warps read a stage and release
// it, gather x[tile_src_part * q + src_local] for all their edges of the
// stage before any of their adds, so the gathers overlap, and then add each
// product to shared memory, except where a warp's hub cache (HubCache) holds
// the destination: those sum in registers and reach shared memory once.  The
// stage geometry, the consumer count and the cache's size and probe interval
// were chosen on the card among a few candidates at the scale-22 shapes.
//
// Shared memory at q = 32,768: y takes 131,072 B; the ring takes
// ring_bytes(13) = 3 x 2048 x 13 + 1,536 + 16 + 48 = 81,472 B (sized for
// the weighted edge either way); 212,544 B in all, under the 232,448 B a
// block may have.  So a block holds at most kMaxChunk = 32,768 outputs,
// and a partition wider than that is split over several blocks, each
// walking all the partition's tiles and keeping the edges that land in its
// slice.  A partition with no tiles is written as 0.
//
// Where the copies' rules are not met (edge_tile not a multiple of 16, or an
// edge array not 16-byte aligned: edge_stream_ok), the same function runs
// with plain loads instead: each warp takes one tile, and each lane loads
// kDirectEdges edges of it before gathering and adding them (through the
// same hub cache).
//
// The TPU kernel sums by a one-hot matmul, so one non-finite product there
// turns its whole partition into NaN; this kernel adds each product into its
// own destination only.  The two agree on finite payloads.
//
// Precondition, checked on the host once per layout (SpmvKernel):
// part_tile_off is the destination-partition structure of the tiles.  A tile
// whose source partition lies outside [0, k), and an edge whose src_local or
// dst_local lies outside [0, q), add nothing.
#include "edge_stream.cuh"

namespace {

using edge_stream::kStageEdges;
using edge_stream::kStages;

constexpr int kMaxChunk = 32768;
constexpr int kConsumerWarps = 24;
constexpr int kRingThreads = 32 * (kConsumerWarps + 1);
constexpr int kPerLane =      // edges a consumer lane takes from a stage
    (kStageEdges + 32 * kConsumerWarps - 1) / (32 * kConsumerWarps);
constexpr int kRingBytes = edge_stream::ring_bytes(13);
constexpr int kDirectThreads = 512;
constexpr int kDirectWarps = kDirectThreads / 32;
constexpr int kDirectEdges = 8;
constexpr int kMaxSmem = 232448;
constexpr int kHubs = 2;           // destinations a warp's hub cache holds
constexpr unsigned kProbe = 16;    // steps between the cache's probes
constexpr unsigned kHubMin = 3;    // lanes on one destination that make a hub

static_assert(4 * kMaxChunk + kRingBytes <= kMaxSmem,
              "y and the ring fit one block's shared memory");

// A warp's cache of the kHubs destinations its edges hit most.  A float
// atomic add to shared memory is a compare-and-swap loop on this card, and an
// RMAT hub draws up to a sixth of a partition's edges onto one address: with
// one atomic per edge the warps queue there, and the partition with the
// largest hub sets the kernel's time.  So each lane adds its edges into a
// cached destination to a register of its own, and the warp adds those sums
// to shared memory once, when the destination leaves the cache or the stream
// ends.  Every kProbe-th step the warp finds its largest group of lanes that
// share a destination (match.any) and, if the group has kHubMin lanes or
// more, caches that destination in place of the oldest.  Other destinations
// take one atomic per edge.  key < 0 adds nothing.
struct HubCache {
  int hub[kHubs];
  float sum[kHubs];
  unsigned step;

  __device__ HubCache() : step(0) {
#pragma unroll
    for (int h = 0; h < kHubs; ++h) { hub[h] = -1; sum[h] = 0.0f; }
  }

  __device__ void add(float* s_y, int key, float t) {
    if (step++ % kProbe == 0) probe(s_y, key);
    bool cached = false;
#pragma unroll
    for (int h = 0; h < kHubs; ++h) {
      if (key >= 0 && key == hub[h]) { sum[h] += t; cached = true; }
    }
    if (!cached && key >= 0) atomicAdd(&s_y[key], t);
  }

  // The warp's sum for slot h goes to shared memory.
  __device__ void spill(float* s_y, int h) const {
    float v = sum[h];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    if ((threadIdx.x & 31) == 0 && hub[h] >= 0) atomicAdd(&s_y[hub[h]], v);
  }

  __device__ void probe(float* s_y, int key) {
    const unsigned all = 0xffffffffu;
    const unsigned lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(all, key);
    const unsigned size =
        key >= 0 && __ffs(peers) - 1 == (int)lane ? __popc(peers) : 0u;
    const unsigned best = __reduce_max_sync(all, size << 5 | lane);
    if (best >> 5 < kHubMin) return;
    const int top = __shfl_sync(all, key, best & 31);
#pragma unroll
    for (int h = 0; h < kHubs; ++h) {
      if (hub[h] == top) return;
    }
    spill(s_y, kHubs - 1);
#pragma unroll
    for (int h = kHubs - 1; h > 0; --h) { hub[h] = hub[h - 1]; sum[h] = sum[h - 1]; }
    hub[0] = top;
    sum[0] = 0.0f;
  }

  __device__ void flush(float* s_y) const {
#pragma unroll
    for (int h = 0; h < kHubs; ++h) spill(s_y, h);
  }
};

template <bool WEIGHTED>
__global__ void __launch_bounds__(kRingThreads) spmv_ring_kernel(
    const float* __restrict__ x, const int* __restrict__ src_local,
    const int* __restrict__ dst_local, const uint8_t* __restrict__ valid,
    const float* __restrict__ w, const int* __restrict__ tile_src_part,
    const long long* __restrict__ part_tile_off, int k, int q, int edge_tile,
    int chunk, int n_chunks, float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_y = reinterpret_cast<float*>(smem);
  // arrays 0..3: src_local, dst_local, valid, w (w only when weighted)
  const void* arrays[4] = {src_local, dst_local, valid, w};
  const int elems[4] = {4, 4, 1, 4};
  edge_stream::Ring ring(smem + edge_stream::align16(4 * chunk),
                         WEIGHTED ? 4 : 3, arrays, elems);

  const int p = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const int lo = c * chunk;
  const int width = min(chunk, q - lo);

  for (int i = threadIdx.x; i < width; i += kRingThreads) s_y[i] = 0.0f;
  if (threadIdx.x == 0) ring.init(kConsumerWarps);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    ring.produce(tile_src_part, part_tile_off[p], part_tile_off[p + 1],
                 edge_tile, [k](int sp) { return sp >= 0 && sp < k; });
  } else {
    HubCache hubs;
    int s = 0;
    uint32_t phase = 0;
    for (;;) {
      const int n = ring.wait(s, phase);
      if (n == 0) break;
      const int* st_src = ring.array<int>(s, 0);
      const int* st_dst = ring.array<int>(s, 1);
      const uint8_t* st_valid = ring.array<uint8_t>(s, 2);
      const float* st_w = WEIGHTED ? ring.array<float>(s, 3) : nullptr;
      const int* st_tag = ring.tag + s * edge_stream::kGroups;
      long long xi[kPerLane];
      int local[kPerLane];
      float wv[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int i = (j * kConsumerWarps + warp) * 32 + lane;
        xi[j] = -1;
        local[j] = 0;
        wv[j] = 1.0f;
        if (i < n) {
          const int src = st_src[i];
          local[j] = st_dst[i] - lo;
          if constexpr (WEIGHTED) wv[j] = st_w[i];
          if (st_valid[i] && src >= 0 && src < q && local[j] >= 0 &&
              local[j] < width)
            xi[j] = (long long)st_tag[i / edge_stream::kGroup] * q + src;
        }
      }
      ring.release(s);
      float v[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[j] = xi[j] >= 0 ? x[xi[j]] : 0.0f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        float t = v[j];
        if constexpr (WEIGHTED) t = t * wv[j];
        hubs.add(s_y, xi[j] >= 0 ? local[j] : -1, t);
      }
      if (++s == kStages) { s = 0; phase ^= 1; }
    }
    hubs.flush(s_y);
  }
  __syncthreads();

  const long long base = (long long)p * q + lo;
  for (int i = threadIdx.x; i < width; i += kRingThreads) y[base + i] = s_y[i];
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(kDirectThreads) spmv_direct_kernel(
    const float* __restrict__ x, const int* __restrict__ src_local,
    const int* __restrict__ dst_local, const uint8_t* __restrict__ valid,
    const float* __restrict__ w, const int* __restrict__ tile_src_part,
    const long long* __restrict__ part_tile_off, int k, int q, int edge_tile,
    int chunk, int n_chunks, float* __restrict__ y) {
  extern __shared__ __align__(16) float s_yd[];

  const int p = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const int lo = c * chunk;
  const int width = min(chunk, q - lo);

  for (int i = threadIdx.x; i < width; i += kDirectThreads) s_yd[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long t1 = part_tile_off[p + 1];
  HubCache hubs;
  for (long long t = part_tile_off[p] + warp; t < t1; t += kDirectWarps) {
    const int sp = tile_src_part[t];                    // warp-uniform
    if (sp < 0 || sp >= k) continue;
    const long long e0 = t * edge_tile;
    const long long xbase = (long long)sp * q;
    for (int b = 0; b < edge_tile; b += 32 * kDirectEdges) {
      long long xi[kDirectEdges];
      int local[kDirectEdges];
      float wv[kDirectEdges];
#pragma unroll
      for (int j = 0; j < kDirectEdges; ++j) {
        const int i = b + j * 32 + lane;
        xi[j] = -1;
        local[j] = 0;
        wv[j] = 1.0f;
        if (i < edge_tile) {
          const long long e = e0 + i;
          const int src = src_local[e];
          local[j] = dst_local[e] - lo;
          if constexpr (WEIGHTED) wv[j] = w[e];
          if (valid[e] && src >= 0 && src < q && local[j] >= 0 &&
              local[j] < width)
            xi[j] = xbase + src;
        }
      }
      float v[kDirectEdges];
#pragma unroll
      for (int j = 0; j < kDirectEdges; ++j)
        v[j] = xi[j] >= 0 ? x[xi[j]] : 0.0f;
#pragma unroll
      for (int j = 0; j < kDirectEdges; ++j) {
        float t = v[j];
        if constexpr (WEIGHTED) t = t * wv[j];
        hubs.add(s_yd, xi[j] >= 0 ? local[j] : -1, t);
      }
    }
  }
  hubs.flush(s_yd);
  __syncthreads();

  const long long base = (long long)p * q + lo;
  for (int i = threadIdx.x; i < width; i += kDirectThreads)
    y[base + i] = s_yd[i];
}

template <bool WEIGHTED>
cudaError_t launch(const void* x, const void* src_local, const void* dst_local,
                   const void* valid, const void* w, const void* tile_src_part,
                   const void* part_tile_off, int k, int q, int edge_tile,
                   int chunk, void* y, cudaStream_t stream) {
  const int n_chunks = (q + chunk - 1) / chunk;
  const void* arrays[4] = {src_local, dst_local, valid, w};
  const bool use_ring =
      edge_stream::edge_stream_ok(arrays, WEIGHTED ? 4 : 3, edge_tile);
  auto kernel = use_ring ? spmv_ring_kernel<WEIGHTED>
                         : spmv_direct_kernel<WEIGHTED>;
  const int threads = use_ring ? kRingThreads : kDirectThreads;
  const size_t smem = use_ring
                          ? edge_stream::align16(4 * chunk) + kRingBytes
                          : sizeof(float) * (size_t)chunk;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<k * n_chunks, threads, smem, stream>>>(
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
// weighted is nonzero.  chunk (at most kMaxChunk) is the widest slice of a
// partition one block holds.  The tiles stream through the ring where the
// copies' rules allow (edge_stream_ok), and are loaded directly otherwise.
extern "C" int spmv_block(const void* x, const void* src_local,
                          const void* dst_local, const void* valid,
                          const void* w, const void* tile_src_part,
                          const void* part_tile_off, int k, int q,
                          int edge_tile, int chunk, int weighted, void* y,
                          void* stream) {
  if (k <= 0 || q <= 0 || edge_tile <= 0 || chunk <= 0 || chunk > kMaxChunk)
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
