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
// Design: the destination-major skeleton of partition_fold.cuh, which
// segment_combine.cu and fused_dc.cu share; this file gives it its edge
// policy (SpmvEdges).  One thread block owns one destination partition's q
// outputs in shared memory (zeroed at the start: the TPU kernel's reset at
// tile_first) and writes its slice of y once; no global atomics.  The
// partition's tiles stream through a ring of shared-memory stages
// (edge_stream.cuh): one producer warp keeps three stages of 2048 edges in
// flight with bulk asynchronous copies, skipping a tile whose source
// partition lies outside [0, k).  The consumer warps read a stage and
// release it, gather x[tile_src_part * q + src_local] for all their edges of
// the stage before any of their adds, so the gathers overlap, and then add
// each product to shared memory, except where a warp's hub cache
// (partition_fold.cuh) holds the destination: those sum in registers and
// reach shared memory once.
//
// Shared memory at q = 32,768: y takes 131,072 B; the weighted ring takes
// Ring::bytes(13) = 3 x 2048 x 13 + 1,536 + 16 + 48 = 81,472 B (the
// unweighted one 9 B an edge); 212,544 B in all, under the 232,448 B a block
// may have.  So a block holds at most kMaxChunk = 32,768 outputs, and a
// partition wider than that is split over several blocks, each walking all
// the partition's tiles and keeping the edges that land in its slice.  A
// partition with no tiles is written as 0.
//
// Where the copies' rules are not met (edge_tile not a multiple of 16, or an
// edge array not 16-byte aligned: edge_stream_ok), the skeleton's plain-load
// kernel runs instead: each warp takes one tile, and each lane loads
// partition_fold::kDirectEdges edges of it before gathering and adding them
// (through the same hub cache).
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
#include "partition_fold.cuh"

namespace {

using partition_fold::Slice;

constexpr int kMaxChunk = 32768;

static_assert(4 * kMaxChunk + edge_stream::Ring<3, 2048>::bytes(13) <=
                  partition_fold::kMaxSmem,
              "y and the ring fit one block's shared memory");

// An edge adds x[its source] (times its weight, with WEIGHTED) into its
// destination if it is valid and both its offsets lie in [0, q); a tile
// whose source partition is outside [0, k) is not read (partition_fold.cuh,
// "Edge policies").
template <bool WEIGHTED>
struct SpmvEdges {
  using Value = float;
  using Ring = edge_stream::Ring<3, 2048>;
  static constexpr int kMonoid = MONOID_ADD;
  static constexpr bool kTouched = false;
  static constexpr bool kLanes = false;
  static constexpr bool kFlat = false;
  static constexpr int kArrays = WEIGHTED ? 4 : 3;
  const void* arrays[4];   // src_local, dst_local, valid, w
  int elems[4];
  const float* x;
  int k, q;

  struct Edge {
    long long xi = 0;   // the source's index into x
    int key = -1;
    float w = 1.0f;
    float v = 0.0f;
  };

  __device__ bool live(int sp) const { return sp >= 0 && sp < k; }

  __device__ Edge read(const void* const* a, long long i, int tag,
                       const Slice& b) const {
    Edge ed;
    const int src = static_cast<const int*>(a[0])[i];
    const int local = static_cast<const int*>(a[1])[i] - b.lo;
    if constexpr (WEIGHTED) ed.w = static_cast<const float*>(a[3])[i];
    if (static_cast<const uint8_t*>(a[2])[i] && src >= 0 && src < q &&
        local >= 0 && local < b.width) {
      ed.key = local;
      ed.xi = (long long)tag * q + src;
    }
    return ed;
  }

  __device__ void gather(Edge& ed) const {
    if (ed.key >= 0) ed.v = __ldg(x + ed.xi);
  }

  __device__ int key(const Edge& ed) const { return ed.key; }

  __device__ float value(const Edge& ed) const {
    if constexpr (WEIGHTED) return ed.v * ed.w;
    else return ed.v;
  }
};

template <bool WEIGHTED>
cudaError_t launch(const void* x, const void* src_local, const void* dst_local,
                   const void* valid, const void* w,
                   const partition_fold::Parts& parts, void* y,
                   cudaStream_t stream) {
  const SpmvEdges<WEIGHTED> e{{src_local, dst_local, valid, w},
                              {4, 4, 1, 4},
                              static_cast<const float*>(x),
                              parts.k,
                              parts.q};
  return partition_fold::launch_tiles(e, parts, y, nullptr, stream);
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
  const partition_fold::Parts parts{
      static_cast<const int*>(tile_src_part),
      static_cast<const long long*>(part_tile_off), k, q, edge_tile, chunk,
      0, (long long)k * q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weighted)
    return (int)launch<true>(x, src_local, dst_local, valid, w, parts, y, s);
  return (int)launch<false>(x, src_local, dst_local, valid, w, parts, y, s);
}

extern "C" const char* spmv_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
