// The fused DC step on Hopper: gather each edge's source value from the vertex
// table and fold it into its destination vertex.
//
// Replaces the Pallas kernel repro.kernels.fused_step.fused_scatter_fold
// (src/repro/kernels/fused_step.py:192).  Python side:
// repro_torch/kernels/fused_step.py (fused_dc_cuda).
//
// What bounds it on this card: by the bytes it must move, 0.19 ms at RMAT
// scale 22 (every edge reads its source and destination offsets, 4 B each,
// and validity, 1 B, once, and SSSP's weight, 4 B; the table and its validity
// are read and acc and touched written once, 5 B a vertex each).  Two costs
// that bound leaves out hold it above that: each table gather moves a 32-byte
// L2 sector for 4 bytes and its validity gather another (the table of
// n_pad + 1 values and its validity bytes, about 21 MB at scale 22, fit the
// 50 MB L2); and a float atomicAdd into shared memory is a compare-and-swap
// loop on sm_90a, onto which RMAT hubs put up to a sixth of a partition's
// edges: with one atomic per edge the warps queue on the hubs' addresses, and
// the partition with the largest hub sets the kernel's time.
//
// Design: the destination-major skeleton of partition_fold.cuh, which
// spmv_block.cu and segment_combine.cu share, with touched flags and every
// monoid; this file gives it its edge policy (FusedEdges).  The edges are
// read in the layout's tile form: destination partition p's tiles are
// [part_tile_off[p], part_tile_off[p+1]), and edge e of tile t has source
// tile_src_part[t] * q + src_local[e] (clamped into [0, table_len), as the
// reference clamps idx) and destination p * q + dst_local[e].  One thread
// block owns one destination partition: it sets that partition's q
// accumulators to the identity and its touched flags to 0 in shared memory,
// folds its tiles into them, and writes its slice of acc and touched once; no
// global atomics, and no block reads another block's output (the paper's
// lock- and atomic-free partition-centric gather).  The tiles stream through
// a ring of shared-memory stages (edge_stream.cuh) filled by one producer
// warp with bulk asynchronous copies.  Consumer warps read a stage and
// release it, then gather table[s] and table_valid[s] for all their edges of
// the stage before any fold, so the gathers overlap, and fold each edge whose
// edge and source are valid: float add through the warp's register cache of
// its hub destinations (partition_fold.cuh SharedFold), integer add and
// min/max as one native shared-memory atomic.  Segments at or above k*q (the
// engines' sentinel n_pad) receive nothing: identity, untouched.
//
// Shared memory at q = 32,768: accumulators and touched flags take 163,840 B.
// The unweighted ring (three stages of 2048 edges at 9 B) takes
// Ring::bytes(9) = 56,896 B, 220,736 B in all; the weighted one (13 B an
// edge) takes three stages of 1536 edges, Ring::bytes(13) = 61,120 B, 224,960
// B in all; both under the 232,448 B a block may have.  So a block holds at
// most kMaxChunk<T> = 32,768 four-byte segments, and a partition wider than
// that is split over several blocks, each walking all the partition's tiles
// and keeping the edges that land in its slice.  Eight-byte accumulators
// (the int64 min of min_with_payload) take 9 B a segment: 32,768 of them
// would need 294,912 B, so kMaxChunk<long long> = 16,384 (147,456 B beside
// either ring) and a q = 32,768 partition takes two blocks.
//
// The 8-byte min has two edge functions: none (BFS seeded from landmarks)
// and EDGE_ADD_WEIGHT_TO_KEY (SSSP with parents), which reads the high word
// of the packed (f32 key << 32) | payload value as a float, adds the edge's
// weight with __fadd_rn (one rounding to nearest, as the reference's f32
// add; never contracted) and packs the sum back over the same payload.  The
// hub cache stays float add only: these folds are one native 64-bit
// shared-memory atomicMin an edge.
//
// Where the copies' rules are not met (edge_tile not a multiple of 16, or an
// edge array not 16-byte aligned: edge_stream_ok), the skeleton's plain-load
// kernel runs instead: each warp takes one tile, and each lane loads
// partition_fold::kDirectEdges edges of it before gathering and folding them.
//
// The lane form (fused_dc_lanes, the batched engine's step): `lanes` tables
// fold over the same edges in one launch, lane b's blocks on blockIdx.y == b,
// each as a single-lane launch's block with lane b's table, validity and
// outputs (partition_fold.cuh, "Lanes").  Each lane's blocks stream the edges
// again, so B lanes move the edge stream B times, where the bound for B lanes
// counts it once (9 B an edge, 13 B weighted) beside B times the per-vertex
// bytes (table 4 + validity 1 + acc 4 + touched 1).  Reading the stream once
// for all lanes needs edges ordered by destination slice or accumulators
// outside shared memory; this form does neither.
//
// Precondition, checked once per layout (FusedDCKernel; the per-edge part on
// the card): part_tile_off is the destination-partition structure of the
// tiles, and every valid edge's global destination is p * q + dst_local with
// dst_local in [0, q).  An edge whose dst_local lies outside [0, q) folds
// nothing.
#include "edge_stream.cuh"
#include "partition_fold.cuh"

namespace {

using partition_fold::Slice;

// The widest slice of a partition a block holds, by accumulator width.
template <typename T>
constexpr int kMaxChunk = sizeof(T) == 8 ? 16384 : 32768;

// The weighted ring is smaller, so that it fits beside kMaxChunk segments.
template <bool WEIGHT>
using RingFor = std::conditional_t<WEIGHT, edge_stream::Ring<3, 1536>,
                                   edge_stream::Ring<3, 2048>>;

template <typename T>
constexpr bool fits() {
  constexpr int slice = edge_stream::align16((sizeof(T) + 1) * kMaxChunk<T>);
  return slice + RingFor<false>::bytes(9) <= partition_fold::kMaxSmem &&
         slice + RingFor<true>::bytes(13) <= partition_fold::kMaxSmem;
}
static_assert(fits<float>() && fits<long long>() &&
                  9 * 2 * kMaxChunk<long long> > partition_fold::kMaxSmem,
              "accumulators, touched flags and the ring fit one block, and "
              "twice kMaxChunk eight-byte segments would not");

__device__ __forceinline__ long long clamp_index(long long s, long long len) {
  return s < 0 ? 0 : (s >= len ? len - 1 : s);
}

// An edge gathers its source's value and validity from the table and folds
// the value, through the edge function EF (EDGE_ADD_WEIGHT: plus its weight;
// EDGE_ADD_WEIGHT_TO_KEY: its weight added to the packed key), into its
// destination if both the edge and the source are valid (partition_fold.cuh,
// "Edge policies").
template <int M, typename T, int EF>
struct FusedEdges {
  static constexpr bool WEIGHT = EF != EDGE_NONE;
  using Value = T;
  using Ring = RingFor<WEIGHT>;
  static constexpr int kMonoid = M;
  static constexpr bool kTouched = true;
  static constexpr int kArrays = WEIGHT ? 4 : 3;
  const void* arrays[4];   // src_local, dst_local, valid, w
  int elems[4];
  const T* table;
  const uint8_t* table_valid;
  long long table_len;
  int q;
  long long table_stride = 0;         // entries between two lanes' tables
  long long lane_stride[4] = {};      // the edges are every lane's

  __device__ void to_lane(long long b) {
    table += b * table_stride;
    table_valid += b * table_stride;
  }

  struct Edge {
    long long si = 0;   // the source's table index
    int key = -1;
    float w = 0.0f;
    uint8_t tv = 0;
    T v = T(0);
  };

  __device__ bool live(int) const { return true; }

  __device__ Edge read(const void* const* a, long long i, int tag,
                       const Slice& b) const {
    Edge ed;
    const int local = static_cast<const int*>(a[1])[i] - b.lo;
    ed.si = clamp_index(
        (long long)tag * q + static_cast<const int*>(a[0])[i], table_len);
    if constexpr (WEIGHT) ed.w = static_cast<const float*>(a[3])[i];
    if (static_cast<const uint8_t*>(a[2])[i] && local >= 0 && local < b.width)
      ed.key = local;
    return ed;
  }

  __device__ void gather(Edge& ed) const {
    if (ed.key >= 0) {
      ed.tv = __ldg(table_valid + ed.si);
      ed.v = __ldg(table + ed.si);
    }
  }

  __device__ int key(const Edge& ed) const { return ed.tv ? ed.key : -1; }

  __device__ T value(const Edge& ed) const {
    return apply_edge<EF>(ed.v, ed.w);
  }
};

template <int M, typename T, int EF>
cudaError_t launch(const void* table, const void* table_valid,
                   long long table_len, long long table_stride,
                   const void* src_local, const void* dst_local,
                   const void* valid, const void* w,
                   const partition_fold::Parts& parts, void* acc,
                   void* touched, cudaStream_t stream) {
  FusedEdges<M, T, EF> e{{src_local, dst_local, valid, w},
                             {4, 4, 1, 4},
                             static_cast<const T*>(table),
                             static_cast<const uint8_t*>(table_valid),
                             table_len,
                             parts.q,
                             table_stride};
  return partition_fold::launch_tiles(e, parts, acc, touched, stream);
}

// Both C entries: `lanes` tables of table_len entries, table_stride apart,
// folded into `lanes` outputs of num_segments entries, out_stride apart.
int run(const void* table, const void* table_valid, long long table_len,
        long long table_stride, const void* src_local, const void* dst_local,
        const void* valid, const void* w, const void* tile_src_part,
        const void* part_tile_off, int k, int q, int edge_tile, int chunk,
        long long num_segments, int lanes, long long out_stride, int monoid,
        int dtype, int edge_fn, void* acc, void* touched, void* stream) {
  if (k <= 0 || q <= 0 || edge_tile <= 0 || chunk <= 0 ||
      table_len <= 0 || num_segments < (long long)k * q || lanes < 1 ||
      lanes > partition_fold::kMaxLanes ||
      (lanes > 1 && (table_stride < table_len || out_stride < num_segments)))
    return (int)cudaErrorInvalidValue;
  partition_fold::Parts parts{
      static_cast<const int*>(tile_src_part),
      static_cast<const long long*>(part_tile_off), k, q, edge_tile, chunk,
      0, num_segments};
  parts.lanes = lanes;
  parts.lane_segments = out_stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    if (chunk > kMaxChunk<T>) return cudaErrorInvalidValue;
    return dispatch_edge<T>(edge_fn, [&](auto ef) -> cudaError_t {
      return launch<C::monoid, T, decltype(ef)::value>(
          table, table_valid, table_len, table_stride, src_local, dst_local,
          valid, w, parts, acc, touched, s);
    });
  });
}

}  // namespace

// Returns 0 or the cudaError_t of the launch.  Pointers are device pointers:
// table and table_valid hold table_len entries, src_local, dst_local, valid
// (and w) one per edge of the tiles, tile_src_part one per tile,
// part_tile_off k+1, acc and touched num_segments >= k*q.  w is read only
// when edge_fn is EDGE_ADD_WEIGHT (float tables only) or
// EDGE_ADD_WEIGHT_TO_KEY (long long tables only); dtype DTYPE_I64 folds with
// min only.  chunk (at most kMaxChunk<T>: 32,768, or 16,384 for long long)
// is the widest slice of a partition one block holds.  The tiles
// stream through the ring where the copies' rules allow (edge_stream_ok), and
// are loaded directly otherwise.
extern "C" int fused_dc(const void* table, const void* table_valid,
                        long long table_len, const void* src_local,
                        const void* dst_local, const void* valid,
                        const void* w, const void* tile_src_part,
                        const void* part_tile_off, int k, int q, int edge_tile,
                        int chunk, long long num_segments, int monoid,
                        int dtype, int edge_fn, void* acc, void* touched,
                        void* stream) {
  return run(table, table_valid, table_len, 0, src_local, dst_local, valid, w,
             tile_src_part, part_tile_off, k, q, edge_tile, chunk,
             num_segments, 1, 0, monoid, dtype, edge_fn, acc, touched, stream);
}

// The lane form: one launch folds `lanes` tables (the batched engine's
// queries) over the same edges, lane b on blockIdx.y == b.  Lane b's table
// and table_valid start table_stride * b entries in (table_stride >=
// table_len), its acc and touched out_stride * b (out_stride >=
// num_segments); 1 <= lanes <= 65,535.  The rest as fused_dc.
extern "C" int fused_dc_lanes(const void* table, const void* table_valid,
                              long long table_len, long long table_stride,
                              const void* src_local, const void* dst_local,
                              const void* valid, const void* w,
                              const void* tile_src_part,
                              const void* part_tile_off, int k, int q,
                              int edge_tile, int chunk,
                              long long num_segments, int lanes,
                              long long out_stride, int monoid, int dtype,
                              int edge_fn, void* acc, void* touched,
                              void* stream) {
  return run(table, table_valid, table_len, table_stride, src_local,
             dst_local, valid, w, tile_src_part, part_tile_off, k, q,
             edge_tile, chunk, num_segments, lanes, out_stride, monoid, dtype,
             edge_fn, acc, touched, stream);
}

extern "C" const char* fused_dc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
