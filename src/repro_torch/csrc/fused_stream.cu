// The layout-free fused DC step on Hopper: for each edge of an unstructured
// stream, gather its source's value from a table and fold it, through the
// edge function, into its destination segment.
//
// Replaces the Pallas kernel repro.kernels.fused_step.fused_scatter_fold
// (src/repro/kernels/fused_step.py:192) in the call form that has no layout
// behind it: the one the reference's FusedStreamKernel
// (src/repro/kernels/ops.py:414) makes on the distributed engine's receive
// table (src/repro/dist/engine.py:274-299), where idx is each edge's slot in
// the received bins and dst its local destination.  fused_dc.cu serves the
// tile form of a single-device layout.  Python side:
// repro_torch/kernels/fused_step.py (fused_stream_cuda).
//
// Contract (the reference's): idx is clamped into [0, table_len); edge e
// contributes only when edge_valid[e] and table_valid[idx[e]]; the edge
// function (none, EDGE_ADD_WEIGHT, EDGE_ADD_WEIGHT_TO_KEY: fold.cuh) runs on
// the gathered value; a dst outside [0, num_segments) receives nothing;
// acc and touched cover num_segments.
//
// What bounds it on this card: bytes.  Each edge reads its idx and dst (4 B
// each), its validity (1 B) and, weighted, its weight (4 B) once; the table
// and its validity are read once (5 B a slot, 9 B for the packed int64
// words); each segment is written once (5 B, 9 B).  On the distributed
// engine at one rank and RMAT scale 22, 67.3M edges read 28.07M slots into
// 4.19M segments: the edge stream is most of it.
//
// Two regimes, chosen by the caller:
//
//   * partitioned (part_off given): the distributed engine's received bins.
//     A rank's incoming edges are a contiguous range of the layout's gather
//     order (p', p, src, dst), so destination partition j of the rank owns
//     the edges [part_off[j], part_off[j+1]), and every valid edge there has
//     a dst in [j * q, (j + 1) * q); within each (p', p) block idx does not
//     decrease, so the table is read as a stream.  Each block of a grid of
//     parts * ceil(q / chunk) owns one chunk of one partition: it sets the
//     chunk's accumulators and touched flags in shared memory, streams the
//     partition's edges, gathers table[clamp(idx)] and its validity for
//     each edge whose dst lies in the chunk, folds it there, and writes its
//     slice of acc and touched once: no global atomic and no grid barrier,
//     the tile form's lock- and atomic-free gather (partition_fold.cuh's
//     ring_kernel / direct_kernel with fused_edges.cuh's policy, FLAT).  An
//     edge whose dst lies outside its block's chunk is skipped, and
//     segments [parts * q, num_segments) receive nothing.  So the regime
//     computes the contract's function when every edge with edge_valid and
//     a dst in [0, num_segments) lies in the range of partition dst / q <
//     parts; the distributed engine derives the ranges and checks that
//     once, on the card, at set-up (fused_step.part_ranges).  A chunk holds
//     kMaxChunk<T> segments (fused_edges.cuh): a q = 32,768 partition takes
//     one block of four-byte accumulators, or two of eight-byte ones, each
//     streaming all the partition's edges.
//   * stream (no part_off): any dst.  segment_fold.cu's stream fold
//     (stream_fold.cuh: one cooperative launch; the shared-memory regime up
//     to kSharedMaxSegments<T> segments, 40,960 four-byte and 22,752
//     eight-byte ones, global atomics past it), with the table gather and
//     the edge function in its message source.  Warps combine runs of
//     equal adjacent dst before an atomic; in the gather order those arise
//     only where consecutive sources each send one edge to the same
//     destination, so past kSharedMaxSegments nearly every edge is one
//     global atomic.
#include "fused_edges.cuh"
#include "partition_fold.cuh"
#include "stream_fold.cuh"

namespace {

using fused_edges::clamp_index;

// Edge i gathers table[clamp(idx[i])] when it and that slot are valid and
// its dst is in range, and applies the edge function EF with its weight.
template <typename T, int EF>
struct TableEdges {
  const T* table;
  const uint8_t* table_valid;
  long long table_len;
  const int* idx;
  const uint8_t* edge_valid;
  const int* dst;
  const float* w;

  __device__ __forceinline__ void load(long long i, long long ns, int& key,
                                       T& v) const {
    const int d = dst[i];
    if (!edge_valid[i] || d < 0 || d >= ns) return;
    const long long s = clamp_index(idx[i], table_len);
    if (!__ldg(table_valid + s)) return;
    float wt = 0.0f;
    if constexpr (EF != EDGE_NONE) wt = w[i];
    key = d;
    v = apply_edge<EF>(__ldg(table + s), wt);
  }
};

}  // namespace

// Returns 0 or the cudaError_t of the launch.  Pointers are device pointers
// on the current device, whose index is `device`: table and table_valid hold
// table_len entries; idx, edge_valid, dst (and w) one per edge, n in all;
// acc and touched num_segments, 16-byte aligned.  w is read only when
// edge_fn is EDGE_ADD_WEIGHT (float tables only) or EDGE_ADD_WEIGHT_TO_KEY
// (long long tables only); dtype DTYPE_I64 folds with min only.
//
// part_off null: the stream regime.  Otherwise the partitioned regime over
// `parts` partitions of q destinations (parts * q <= num_segments):
// part_off holds parts + 1 int64 edge offsets, nondecreasing multiples of
// `tile` with part_off[parts] <= n (n a multiple of tile); partition j's
// edges are [part_off[j], part_off[j+1]).  The edges stream through the
// ring where the arrays are 16-byte aligned and tile is a multiple of 16,
// and are loaded directly otherwise; a plain-load warp takes one tile at a
// time.
extern "C" int fused_stream(const void* table, const void* table_valid,
                            long long table_len, const void* idx,
                            const void* edge_valid, const void* dst,
                            const void* w, long long n, const void* part_off,
                            int parts, int q, int tile,
                            long long num_segments, int monoid, int dtype,
                            int edge_fn, void* acc, void* touched, int device,
                            void* stream) {
  const cudaError_t bad =
      stream_fold::check_args(n, num_segments, device, acc, touched);
  if (bad != cudaSuccess) return (int)bad;
  if (table_len <= 0) return (int)cudaErrorInvalidValue;
  if (part_off != nullptr &&
      (parts <= 0 || q <= 0 || tile <= 0 || n % tile != 0 ||
       (long long)parts * q > num_segments))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    return dispatch_edge<T>(edge_fn, [&](auto ef) -> cudaError_t {
      constexpr int EF = decltype(ef)::value;
      if (part_off != nullptr) {
        const partition_fold::Parts P{
            nullptr, static_cast<const long long*>(part_off), parts, q,
            tile, q < fused_edges::kMaxChunk<T> ? q : fused_edges::kMaxChunk<T>,
            0, num_segments};
        return fused_edges::launch<C::monoid, T, EF, true>(
            table, table_valid, table_len, idx, dst, edge_valid, w, P, acc,
            touched, s);
      }
      const TableEdges<T, EF> src{
          static_cast<const T*>(table),
          static_cast<const uint8_t*>(table_valid),
          table_len,
          static_cast<const int*>(idx),
          static_cast<const uint8_t*>(edge_valid),
          static_cast<const int*>(dst),
          static_cast<const float*>(w)};
      return stream_fold::launch<C::monoid, T>(src, n, num_segments, acc,
                                               touched, device, s);
    });
  });
}

extern "C" const char* fused_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
