// The fused DC step's edge policy for the destination-major skeleton
// (partition_fold.cuh, "Edge policies"), shared by the tile form
// (fused_dc.cu) and the partitioned regime of the layout-free form
// (fused_stream.cu): an edge gathers its source's value and validity from
// the table and folds the value, through the edge function EF
// (EDGE_ADD_WEIGHT: plus its weight; EDGE_ADD_WEIGHT_TO_KEY: its weight
// added to the packed key), into its destination if both the edge and the
// source are valid and the destination lies in the block's slice.
//
// The two forms differ only in how an edge names its source and
// destination:
//   * tiles (FLAT = false): the layout's src_local and dst_local, the source
//     at tile_src_part[t] * q + src_local (the tile's tag) and the
//     destination at p * q + dst_local;
//   * flat (FLAT = true): the table slot idx and the destination dst of the
//     distributed engine's received bins, dst counted from the rank's first
//     vertex, so that partition p's destinations are [p * q, (p + 1) * q).
// Either way the source index is clamped into [0, table_len), as the
// reference clamps idx.
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
#pragma once

#include <type_traits>

#include "edge_stream.cuh"
#include "partition_fold.cuh"

namespace fused_edges {

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

template <int M, typename T, int EF, bool FLAT>
struct FusedEdges {
  static constexpr bool WEIGHT = EF != EDGE_NONE;
  using Value = T;
  using Ring = RingFor<WEIGHT>;
  static constexpr int kMonoid = M;
  static constexpr bool kTouched = true;
  static constexpr bool kLanes = false;   // the lane form reads the edge copy
  static constexpr bool kFlat = FLAT;
  static constexpr int kArrays = WEIGHT ? 4 : 3;
  const void* arrays[4];   // src_local (flat: idx), dst_local (dst), valid, w
  int elems[4];
  const T* table;
  const uint8_t* table_valid;
  long long table_len;
  int q;

  struct Edge {
    long long si = 0;   // the source's table index
    int key = -1;
    float w = 0.0f;
    uint8_t tv = 0;
    T v = T(0);
  };

  __device__ bool live(int) const { return true; }

  __device__ Edge read(const void* const* a, long long i, int tag,
                       const partition_fold::Slice& b) const {
    Edge ed;
    const int* src = static_cast<const int*>(a[0]);
    const int d = static_cast<const int*>(a[1])[i];
    int local;
    if constexpr (FLAT) {
      local = d - (b.p * q + b.lo);
      ed.si = clamp_index(src[i], table_len);
    } else {
      local = d - b.lo;
      ed.si = clamp_index((long long)tag * q + src[i], table_len);
    }
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

// Launches the skeleton over parts with this policy: ring_kernel where the
// arrays and parts.edge_tile allow the ring's copies, else direct_kernel.
template <int M, typename T, int EF, bool FLAT>
cudaError_t launch(const void* table, const void* table_valid,
                   long long table_len, const void* src, const void* dst,
                   const void* valid, const void* w,
                   const partition_fold::Parts& parts, void* acc,
                   void* touched, cudaStream_t stream) {
  const FusedEdges<M, T, EF, FLAT> e{{src, dst, valid, w},
                                     {4, 4, 1, 4},
                                     static_cast<const T*>(table),
                                     static_cast<const uint8_t*>(table_valid),
                                     table_len,
                                     parts.q};
  return partition_fold::launch_tiles(e, parts, acc, touched, stream);
}

}  // namespace fused_edges
