// The Gather phase of the composed DC path on Hopper: fold the gather-order
// [NE] edge-value stream into each destination partition's accumulators.
//
// Replaces the Pallas kernel repro.kernels.segment_combine.segment_combine
// (src/repro/kernels/segment_combine.py:122).  Python side:
// repro_torch/kernels/segment_combine.py (segment_combine_cuda).
//
// What bounds it on this card: by the bytes it must move, 0.19 ms at RMAT
// scale 22 (every edge of a live tile reads its value, 4 B, validity, 1 B,
// and destination offset, 4 B, once; each partition's q accumulators and
// touched flags are written once, 5 B a vertex).  What the bound leaves out
// is the float add: an atomicAdd into shared memory is a compare-and-swap
// loop on sm_90a, and RMAT hubs put up to a sixth of a partition's edges on
// one address, so with one atomic per edge the warps queue there.
//
// Design: the destination-major skeleton of partition_fold.cuh, which
// spmv_block.cu and fused_dc.cu share; this file gives it its edge policy
// (CombineEdges).  Edge tiles are destination-major, so the tiles of
// destination partition p are [part_tile_off[p], part_tile_off[p+1]).  One
// thread block owns one destination partition: it sets that partition's q
// accumulators to the identity in shared memory (the TPU kernel's reset at
// tile_first), folds its tiles into them, and writes its slice of acc and
// touched once; no global atomics, and no block reads another block's
// output.  The tiles stream through a ring of shared-memory stages
// (edge_stream.cuh): one producer warp keeps three stages of 2048 edges in
// flight with bulk asynchronous copies and skips each tile whose source
// partition is outside [0, k) or inactive (part_active[tile_src_part[t]] ==
// 0, the paper's 2-level active list), so a skipped tile costs no edge
// bytes.  Consumer warps read a stage, release it, and fold each edge: float
// add through the warp's register cache of its hub destinations
// (partition_fold.cuh SharedFold), integer add and min/max as one native
// shared-memory atomic.
//
// Shared memory at q = 32,768: accumulators and touched flags take 163,840
// B, the ring Ring::bytes(9) = 56,896 B; 220,736 B in all, under the 232,448
// B a block may have.  So a block holds at most kMaxChunk<T> = 32,768
// four-byte segments, and a partition wider than that is split over several
// blocks, each walking all the partition's tiles and keeping the edges that
// land in its slice.  A partition with no tiles is written as the identity,
// untouched.  The 8-byte min (the packed words of min_with_payload, as
// int64) streams 13 B an edge, Ring::bytes(13) = 81,472 B, beside at most
// kMaxChunk<long long> = 16,384 segments at 9 B (147,456 B): a q = 32,768
// partition takes two blocks.
//
// Where the copies' rules are not met (edge_tile not a multiple of 16, or an
// edge array not 16-byte aligned: edge_stream_ok), the skeleton's plain-load
// kernel runs instead: each warp takes one tile, and each lane loads
// partition_fold::kDirectEdges edges of it before folding them (through the
// same SharedFold).
//
// The TPU kernel folds float add by a one-hot matmul, so one non-finite
// message there turns its whole partition into NaN; this kernel folds each
// edge into its own destination only.  The two agree on finite payloads,
// which is what the parity tests use.
//
// The lane form (segment_combine_lanes, the batched engine's composed step):
// `lanes` edge streams [lanes, NE] with their part_active rows [lanes, k]
// fold over the same tiles in one launch, lane b's blocks on blockIdx.y == b
// (partition_fold.cuh, "Lanes"); each lane skips the tiles of its own
// inactive source partitions.  Every byte it reads is the lane's own but
// dst_local, so B lanes move B times a lane's stream; its bound counts
// dst_local once.
//
// Precondition, checked on the host once per layout (GatherKernel):
// part_tile_off is the destination-partition structure of the tiles.  A tile
// whose source partition lies outside [0, k), and an edge whose dst_local
// lies outside [0, q), fold nothing.
#include "edge_stream.cuh"
#include "partition_fold.cuh"

namespace {

using partition_fold::Slice;

// The widest slice of a partition a block holds, by accumulator width.
template <typename T>
constexpr int kMaxChunk = sizeof(T) == 8 ? 16384 : 32768;

template <typename T>
constexpr int block_bytes() {
  return edge_stream::align16((sizeof(T) + 1) * kMaxChunk<T>) +
         edge_stream::Ring<3, 2048>::bytes(sizeof(T) + 5);
}
static_assert(block_bytes<float>() <= partition_fold::kMaxSmem &&
                  block_bytes<long long>() <= partition_fold::kMaxSmem,
              "accumulators, touched flags and the ring fit one block");

// An edge folds its value into its destination if it is valid; a tile whose
// source partition is outside [0, k) or inactive is not read
// (partition_fold.cuh, "Edge policies").
template <int M, typename T>
struct CombineEdges {
  using Value = T;
  using Ring = edge_stream::Ring<3, 2048>;
  static constexpr int kMonoid = M;
  static constexpr bool kTouched = true;
  static constexpr bool kLanes = true;
  static constexpr bool kFlat = false;
  static constexpr int kArrays = 3;
  const void* arrays[4];   // vals, dst_local, valid
  int elems[4];
  int k;
  const uint8_t* part_active;
  long long part_stride = 0;   // entries between two lanes' part_active
  long long lane_stride[4] = {};

  __device__ void to_lane(long long b) { part_active += b * part_stride; }

  struct Edge {
    int key = -1;
    T v = T(0);
  };

  __device__ bool live(int sp) const {
    return sp >= 0 && sp < k && part_active[sp];
  }

  __device__ Edge read(const void* const* a, long long i, int,
                       const Slice& b) const {
    Edge ed;
    const int local = static_cast<const int*>(a[1])[i] - b.lo;
    ed.v = static_cast<const T*>(a[0])[i];
    if (static_cast<const uint8_t*>(a[2])[i] && local >= 0 && local < b.width)
      ed.key = local;
    return ed;
  }

  __device__ void gather(Edge&) const {}
  __device__ int key(const Edge& ed) const { return ed.key; }
  __device__ T value(const Edge& ed) const { return ed.v; }
};

// Both C entries: `lanes` edge streams (vals and valid), edge_stride apart,
// with their part_active rows part_stride apart, folded into `lanes` outputs
// of k*q entries, out_stride apart.
int run(const void* vals, const void* valid, const void* dst_local,
        const void* tile_src_part, const void* part_tile_off,
        const void* part_active, int k, int q, int edge_tile, int chunk,
        int lanes, long long edge_stride, long long part_stride,
        long long out_stride, int monoid, int dtype, void* acc, void* touched,
        void* stream) {
  if (k <= 0 || q <= 0 || edge_tile <= 0 || chunk <= 0 || lanes < 1 ||
      lanes > partition_fold::kMaxLanes ||
      (lanes > 1 && (edge_stride < 0 || part_stride < k ||
                     out_stride < (long long)k * q)))
    return (int)cudaErrorInvalidValue;
  partition_fold::Parts parts{
      static_cast<const int*>(tile_src_part),
      static_cast<const long long*>(part_tile_off), k, q, edge_tile, chunk,
      0, (long long)k * q};
  parts.lanes = lanes;
  parts.lane_segments = out_stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    if (chunk > kMaxChunk<T>) return cudaErrorInvalidValue;
    const CombineEdges<C::monoid, T> e{
        {vals, dst_local, valid, nullptr},
        {(int)sizeof(T), 4, 1, 0},
        k,
        static_cast<const uint8_t*>(part_active),
        part_stride,
        {edge_stride, 0, edge_stride, 0}};
    return partition_fold::launch_tiles(e, parts, acc, touched, s);
  });
}

}  // namespace

// Returns 0 or the cudaError_t of the launch.  Pointers are device pointers;
// acc and touched hold k*q entries, part_tile_off k+1.  chunk (at most
// kMaxChunk<T>: 32,768, or 16,384 for long long) is the widest slice of a
// partition one block holds; dtype DTYPE_I64 folds with min only.  The tiles
// stream through the ring where the copies' rules allow (edge_stream_ok), and
// are loaded directly otherwise.
extern "C" int segment_combine(const void* vals, const void* valid,
                               const void* dst_local,
                               const void* tile_src_part,
                               const void* part_tile_off,
                               const void* part_active, int k, int q,
                               int edge_tile, int chunk, int monoid, int dtype,
                               void* acc, void* touched, void* stream) {
  return run(vals, valid, dst_local, tile_src_part, part_tile_off,
             part_active, k, q, edge_tile, chunk, 1, 0, 0, 0, monoid, dtype,
             acc, touched, stream);
}

// The lane form: one launch folds `lanes` edge streams over the same tiles,
// lane b on blockIdx.y == b.  Lane b's vals and valid start edge_stride * b
// edges in, its part_active part_stride * b entries (>= k), its acc and
// touched out_stride * b (>= k*q); 1 <= lanes <= 65,535.  The ring streams a
// lane's arrays where both its bases are 16-byte aligned (edge_stride a
// multiple of 16 keeps every lane's so), plain loads serve the launch
// otherwise.  The rest as segment_combine.
extern "C" int segment_combine_lanes(
    const void* vals, const void* valid, const void* dst_local,
    const void* tile_src_part, const void* part_tile_off,
    const void* part_active, int k, int q, int edge_tile, int chunk,
    int lanes, long long edge_stride, long long part_stride,
    long long out_stride, int monoid, int dtype, void* acc, void* touched,
    void* stream) {
  return run(vals, valid, dst_local, tile_src_part, part_tile_off,
             part_active, k, q, edge_tile, chunk, lanes, edge_stride,
             part_stride, out_stride, monoid, dtype, acc, touched, stream);
}

extern "C" const char* segment_combine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
