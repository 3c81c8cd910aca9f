// The destination-major kernels' common skeleton (spmv_block.cu,
// segment_combine.cu, fused_dc.cu, and fused_stream.cu's partitioned
// regime): one thread block owns a slice of one destination partition in
// shared memory, folds that partition's edge tiles into it and writes it
// once.  Here: the block's slice, the reset and write-back of its
// accumulators and touched flags, a warp's register cache
// of the destinations its edges hit most (HubCache) and the policy that
// chooses between it and one atomic per edge (SharedFold), and the two
// kernels every file launches, one that streams the tiles through
// edge_stream.cuh's ring (ring_kernel) and one with plain loads where the
// ring's copies are not allowed (direct_kernel).  A file gives them an edge
// policy, which says what an edge reads and where it folds (see "Edge
// policies" below).
//
// Why the cache: a float atomic add to shared memory is a compare-and-swap
// loop on sm_90a, and an RMAT hub draws up to a sixth of a partition's edges
// onto one address: with one atomic per edge the warps queue there, and the
// partition with the largest hub sets the kernel's time.  So each lane adds
// its edges into a cached destination to a register of its own, and the warp
// adds those sums to shared memory once, when the destination leaves the
// cache or the stream ends.  Every kProbe-th step the warp finds its largest
// group of lanes that share a destination (match.any) and, if the group has
// kHubMin lanes or more, caches that destination in place of the oldest.
// Other destinations take one atomic per edge.  key < 0 adds nothing.  Only
// float add takes the cache: the integer adds and min/max are single native
// shared-memory atomics on this card, and the integer adds through the cache
// measured 15-17 % slower.
//
// With TOUCHED, each add also marks its destination in a byte array beside
// the sums.  A cached destination is marked when its slot spills, if any
// lane of the warp hit it: a sum equal to 0 (zero payloads) still marks.
// Every call is made by the whole warp (the probe and the spill are warp
// collectives), on keys that may differ from lane to lane.
//
// Lanes (the batched engine's queries): a launch of a policy with kLanes may
// fold `lanes` independent inputs over the same tiles, lane b on blockIdx.y
// == b.  A lane's blocks are a single-lane launch's blocks with the lane's
// pointers: each per-edge array
// advances by its policy's lane_stride (elements; 0 for the layout's arrays,
// which every lane shares), the policy moves its own per-lane tables
// (to_lane), and acc and touched advance by Parts::lane_segments.  Each lane's
// blocks read the edge stream again.  The offsets are 64-bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "edge_stream.cuh"
#include "fold.cuh"

namespace partition_fold {

constexpr int kHubs = 2;           // destinations a warp's cache holds
constexpr unsigned kProbe = 16;    // steps between the cache's probes
constexpr unsigned kHubMin = 3;    // lanes on one destination that make a hub

// The blocks: ring_kernel has kConsumerWarps consumer warps and one producer
// warp; direct_kernel's warps each take one tile at a time and load
// kDirectEdges of its edges a lane before folding them.  These, the stage
// geometries and the cache's size and probe interval were chosen on the card
// among a few candidates at the scale-22 shapes.
constexpr int kConsumerWarps = 24;
constexpr int kRingThreads = 32 * (kConsumerWarps + 1);
constexpr int kDirectThreads = 512;
constexpr int kDirectWarps = kDirectThreads / 32;
constexpr int kDirectEdges = 8;
constexpr int kMaxSmem = 232448;   // a block's dynamic shared memory

template <typename T, bool TOUCHED>
struct HubCache {
  int hub[kHubs];
  T sum[kHubs];
  unsigned hits;     // bit h: this lane added into slot h since it was set
  unsigned step;

  __device__ HubCache() : hits(0), step(0) {
#pragma unroll
    for (int h = 0; h < kHubs; ++h) { hub[h] = -1; sum[h] = T(0); }
  }

  __device__ void add(T* s_acc, uint8_t* s_touched, int key, T t) {
    if (step++ % kProbe == 0) probe(s_acc, s_touched, key);
    bool cached = false;
#pragma unroll
    for (int h = 0; h < kHubs; ++h) {
      if (key >= 0 && key == hub[h]) {
        sum[h] += t;
        hits |= 1u << h;
        cached = true;
      }
    }
    if (!cached && key >= 0) {
      atomicAdd(&s_acc[key], t);
      if constexpr (TOUCHED) s_touched[key] = 1;
    }
  }

  // The warp's sum for slot h goes to shared memory, if any lane hit it.
  __device__ void spill(T* s_acc, uint8_t* s_touched, int h) const {
    T v = sum[h];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    const bool hit = __any_sync(0xffffffffu, (hits >> h) & 1u);
    if ((threadIdx.x & 31) == 0 && hit) {
      atomicAdd(&s_acc[hub[h]], v);
      if constexpr (TOUCHED) s_touched[hub[h]] = 1;
    }
  }

  __device__ void probe(T* s_acc, uint8_t* s_touched, int key) {
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
    spill(s_acc, s_touched, kHubs - 1);
#pragma unroll
    for (int h = kHubs - 1; h > 0; --h) {
      hub[h] = hub[h - 1];
      sum[h] = sum[h - 1];
    }
    hits = (hits << 1) & ((1u << kHubs) - 1);
    hub[0] = top;
    sum[0] = T(0);
  }

  __device__ void flush(T* s_acc, uint8_t* s_touched) const {
#pragma unroll
    for (int h = 0; h < kHubs; ++h) spill(s_acc, s_touched, h);
  }
};

// Folds a warp's edges into one partition's shared accumulators (and, with
// TOUCHED, its touched flags): float add through the warp's HubCache,
// otherwise one native atomic (and one flag store) per edge (fold.cuh).
// key < 0 folds nothing.  Called by the whole warp.
template <int M, typename T, bool TOUCHED>
struct SharedFold {
  static constexpr bool kCached =
      M == MONOID_ADD && std::is_same_v<T, float>;
  HubCache<T, TOUCHED> hubs;   // unused unless kCached

  __device__ void add(T* s_acc, uint8_t* s_touched, int key, T v) {
    if constexpr (kCached) {
      hubs.add(s_acc, s_touched, key, v);
    } else if (key >= 0) {
      fold_into<M, T>(&s_acc[key], v);
      if constexpr (TOUCHED) s_touched[key] = 1;
    }
  }

  __device__ void flush(T* s_acc, uint8_t* s_touched) const {
    if constexpr (kCached) hubs.flush(s_acc, s_touched);
  }
};

// Block (p, c) of a grid of k * n_chunks: partition p's slice [lo, lo +
// width) of its q segments.
struct Slice {
  int p, lo, width;
  __device__ Slice(int q, int chunk, int n_chunks) {
    const int block = blockIdx.x;
    p = block / n_chunks;
    lo = block % n_chunks * chunk;
    width = min(chunk, q - lo);
  }
};

// The block's slice of accumulators to the identity (and untouched).
template <int M, typename T, bool TOUCHED>
__device__ void reset(T* s_acc, uint8_t* s_touched, int width) {
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    s_acc[i] = identity<M, T>();
    if constexpr (TOUCHED) s_touched[i] = 0;
  }
}

// The block's slice to acc (and touched) at global segment base.
template <typename T, bool TOUCHED>
__device__ void write_back(const T* s_acc, const uint8_t* s_touched,
                           long long base, int width, T* acc,
                           uint8_t* touched) {
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    acc[base + i] = s_acc[i];
    if constexpr (TOUCHED) touched[base + i] = s_touched[i];
  }
}

// The tiles of a launch: destination partition p's tiles are
// [part_tile_off[p], part_tile_off[p+1]), tile t's edges [t * edge_tile,
// (t+1) * edge_tile), and its tag (the ring's tag) tile_src_part[t].  A
// kFlat policy's launch (fused_stream.cu's partitioned regime) has no tags
// (each is 0; tile_src_part is null) and edge offsets in part_tile_off, each
// a multiple of edge_tile.  A block holds chunk of a partition's q segments;
// segments [k*q, num_segments) are written as the identity, untouched, by
// block 0 of each lane.  Lane b's acc and touched start lane_segments * b
// entries in.
struct Parts {
  const int* tile_src_part;
  const long long* part_tile_off;
  int k, q, edge_tile, chunk, n_chunks;
  long long num_segments;
  int lanes = 1;
  long long lane_segments = 0;
};

// Partition p's first tile.
template <class E>
__device__ __forceinline__ long long first_tile(const Parts& P, int p) {
  if constexpr (E::kFlat) return P.part_tile_off[p] / P.edge_tile;
  else return P.part_tile_off[p];
}

constexpr int kMaxLanes = 65535;   // gridDim.y

// Edge policies.  A policy E is a small struct passed to the kernels by
// value.  It has
//   Value, kMonoid, kTouched   the accumulators' type, their monoid, and
//                              whether touched flags are kept;
//   Ring                       its ring's stage geometry (edge_stream::Ring);
//   kArrays, arrays, elems     the per-edge arrays it reads (at most
//                              edge_stream::kMaxArrays) and their element
//                              sizes: what the ring streams;
//   Edge                       an edge's registers between its read and its
//                              fold; a default Edge folds nothing;
//   live(tag)                  whether a tile with this tag is read at all;
//   read(a, i, tag, slice)     edge i of the arrays a (a stage's copies in
//                              shared memory, or the arrays themselves), in a
//                              tile tagged tag, for the block's slice;
//   gather(edge)               its reads of global tables, made after the
//                              stage is released and for all of a lane's
//                              edges before any fold, so that they overlap;
//   key(edge), value(edge)     the slot it folds into (-1: none) and what;
//   kFlat                      whether its launch has edge offsets and no
//                              tags (Parts);
//   kLanes                     whether it takes lanes; only then are the lane
//                              kernels built for it, and only then has it
//   lane_stride                elements between two lanes' copies of each
//                              per-edge array (0: one array for all lanes)
//   to_lane(b)                 and moves its per-lane tables to lane b's.
template <class E>
__host__ __device__ constexpr int slice_bytes(int chunk) {
  return (int)(sizeof(typename E::Value) + (E::kTouched ? 1 : 0)) * chunk;
}

// The policy of lane b: its per-edge arrays and tables moved to lane b's.
template <class E>
__device__ E lane_policy(E e, long long b) {
#pragma unroll
  for (int a = 0; a < E::kArrays; ++a)
    e.arrays[a] = static_cast<const unsigned char*>(e.arrays[a]) +
                  b * e.lane_stride[a] * e.elems[a];
  e.to_lane(b);
  return e;
}

// The policy a block folds with: the kernel's own in a single-lane launch,
// its lane's (blockIdx.y) in a lane launch.  Separate instantiations keep
// the lanes' offsets out of the single-lane kernels: with them,
// segment_combine's integer adds and min folds measured 3-4 % slower on an
// H100 (PERF.md §6).
template <bool LANES, class E>
__device__ __forceinline__ E block_policy(const E& e) {
  if constexpr (LANES) return lane_policy(e, blockIdx.y);
  else return e;
}

template <class E>
__device__ void write_tail(const Parts& P, typename E::Value* acc,
                           uint8_t* touched) {
  if (blockIdx.x != 0) return;
  for (long long i = (long long)P.k * P.q + threadIdx.x; i < P.num_segments;
       i += blockDim.x) {
    acc[i] = identity<E::kMonoid, typename E::Value>();
    if constexpr (E::kTouched) touched[i] = 0;
  }
}

// One producer warp streams the partition's live tiles through the ring;
// each consumer warp reads its edges of a stage, releases the stage, gathers
// and folds them.
template <class E, bool LANES>
__global__ void __launch_bounds__(kRingThreads) ring_kernel(
    const E e0, const Parts P, typename E::Value* __restrict__ acc,
    uint8_t* __restrict__ touched) {
  using T = typename E::Value;
  using Ring = typename E::Ring;
  const E e = block_policy<LANES>(e0);
  if constexpr (LANES) {
    acc += blockIdx.y * P.lane_segments;
    if constexpr (E::kTouched) touched += blockIdx.y * P.lane_segments;
  }
  constexpr int kPerLane =    // edges a consumer lane takes from a stage
      (Ring::kStageEdges + 32 * kConsumerWarps - 1) / (32 * kConsumerWarps);
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_acc = reinterpret_cast<T*>(smem);
  uint8_t* s_touched = smem + sizeof(T) * P.chunk;   // with kTouched only
  Ring ring(smem + edge_stream::align16(slice_bytes<E>(P.chunk)), E::kArrays,
            e.arrays, e.elems);
  const Slice b(P.q, P.chunk, P.n_chunks);

  reset<E::kMonoid, T, E::kTouched>(s_acc, s_touched, b.width);
  if (threadIdx.x == 0) ring.init(kConsumerWarps);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    ring.template produce<!E::kFlat>(
        P.tile_src_part, first_tile<E>(P, b.p), first_tile<E>(P, b.p + 1),
        P.edge_tile, [&](int tag) { return e.live(tag); });
  } else {
    SharedFold<E::kMonoid, T, E::kTouched> fold;
    int s = 0;
    uint32_t phase = 0;
    for (;;) {
      const int n = ring.wait(s, phase);
      if (n == 0) break;
      const void* stage[E::kArrays];
#pragma unroll
      for (int a = 0; a < E::kArrays; ++a)
        stage[a] = ring.template array<unsigned char>(s, a);
      const int* tag = ring.tag + s * Ring::kGroups;
      typename E::Edge ed[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int i = (j * kConsumerWarps + warp) * 32 + lane;
        if (i < n) ed[j] = e.read(stage, i, tag[i / edge_stream::kGroup], b);
      }
      ring.release(s);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) e.gather(ed[j]);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        fold.add(s_acc, s_touched, e.key(ed[j]), e.value(ed[j]));
      if (++s == Ring::kStages) { s = 0; phase ^= 1; }
    }
    fold.flush(s_acc, s_touched);
  }
  __syncthreads();
  write_back<T, E::kTouched>(s_acc, s_touched, (long long)b.p * P.q + b.lo,
                             b.width, acc, touched);
  write_tail<E>(P, acc, touched);
}

// Plain loads: each warp takes one live tile at a time.
template <class E, bool LANES>
__global__ void __launch_bounds__(kDirectThreads) direct_kernel(
    const E e0, const Parts P, typename E::Value* __restrict__ acc,
    uint8_t* __restrict__ touched) {
  using T = typename E::Value;
  const E e = block_policy<LANES>(e0);
  if constexpr (LANES) {
    acc += blockIdx.y * P.lane_segments;
    if constexpr (E::kTouched) touched += blockIdx.y * P.lane_segments;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_acc = reinterpret_cast<T*>(smem);
  uint8_t* s_touched = smem + sizeof(T) * P.chunk;   // with kTouched only
  const Slice b(P.q, P.chunk, P.n_chunks);

  reset<E::kMonoid, T, E::kTouched>(s_acc, s_touched, b.width);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long t1 = first_tile<E>(P, b.p + 1);
  SharedFold<E::kMonoid, T, E::kTouched> fold;
  for (long long t = first_tile<E>(P, b.p) + warp; t < t1; t += kDirectWarps) {
    int tag = 0;                                         // warp-uniform
    if constexpr (!E::kFlat) tag = P.tile_src_part[t];
    if (!e.live(tag)) continue;
    const long long e0 = t * P.edge_tile;
    for (int base = 0; base < P.edge_tile; base += 32 * kDirectEdges) {
      typename E::Edge ed[kDirectEdges];
#pragma unroll
      for (int j = 0; j < kDirectEdges; ++j) {
        const int i = base + j * 32 + lane;
        if (i < P.edge_tile) ed[j] = e.read(e.arrays, e0 + i, tag, b);
      }
#pragma unroll
      for (int j = 0; j < kDirectEdges; ++j) e.gather(ed[j]);
#pragma unroll
      for (int j = 0; j < kDirectEdges; ++j)
        fold.add(s_acc, s_touched, e.key(ed[j]), e.value(ed[j]));
    }
  }
  fold.flush(s_acc, s_touched);
  __syncthreads();
  write_back<T, E::kTouched>(s_acc, s_touched, (long long)b.p * P.q + b.lo,
                             b.width, acc, touched);
  write_tail<E>(P, acc, touched);
}

// Launches ring_kernel where the edge arrays and edge_tile meet the ring's
// copy rules (edge_stream_ok) for every lane, else direct_kernel; one block
// per chunk of a partition and lane (more than one lane: a policy with
// kLanes only).  P.n_chunks is set here.
template <class E>
cudaError_t launch_tiles(const E& e, Parts P, void* acc, void* touched,
                   cudaStream_t stream) {
  const bool lanes = P.lanes > 1;
  if (P.lanes < 1 || P.lanes > kMaxLanes || (lanes && !E::kLanes))
    return cudaErrorInvalidValue;
  P.n_chunks = (P.q + P.chunk - 1) / P.chunk;
  bool use_ring =
      edge_stream::edge_stream_ok(e.arrays, E::kArrays, P.edge_tile);
  int bytes_per_edge = 0;
  for (int a = 0; a < E::kArrays; ++a) bytes_per_edge += e.elems[a];
  auto kernel = use_ring ? ring_kernel<E, false> : direct_kernel<E, false>;
  if constexpr (E::kLanes) {
    if (lanes) {
      for (int a = 0; a < E::kArrays; ++a)
        use_ring = use_ring && e.lane_stride[a] * e.elems[a] % 16 == 0;
      kernel = use_ring ? ring_kernel<E, true> : direct_kernel<E, true>;
    }
  }
  const int slice = slice_bytes<E>(P.chunk);
  const size_t smem =
      use_ring ? edge_stream::align16(slice) + E::Ring::bytes(bytes_per_edge)
               : slice;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(P.k * P.n_chunks, P.lanes);
  kernel<<<grid, use_ring ? kRingThreads : kDirectThreads, smem, stream>>>(
      e, P, static_cast<typename E::Value*>(acc),
      static_cast<uint8_t*>(touched));
  return cudaGetLastError();
}

}  // namespace partition_fold
