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
// monoid; fused_edges.cuh gives it its edge policy (FusedEdges, shared
// with fused_stream.cu's partitioned regime).  The edges are
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
// Shared memory at q = 32,768 (fused_edges.cuh): the accumulators, touched
// flags and ring fit one block for kMaxChunk<T> = 32,768 four-byte segments;
// eight-byte ones take two blocks of 16,384, each walking all the
// partition's tiles and keeping the edges that land in its slice.
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
// The lane form (fused_dc_interleave then fused_dc_lanes, the batched
// engine's step): `lanes` tables fold over the same edges.  Read the tile way,
// lane by lane, B lanes would move the edge stream B times and make B
// separate random gathers an edge, each a 32-byte sector for 4 bytes, where
// the bound counts the stream once (9 B an edge, 13 B weighted) beside B
// times the per-vertex bytes (table 4 + validity 1 + acc 4 + touched 1).  So
// the lane form reads another copy of the edges, built once per layout on the
// card (repro_torch.kernels.fused_step.build_lane_edges): each destination
// partition's valid edges sorted by destination (stable, so a destination's
// edges keep the gather order), as the source's row and the destination's
// local index (4 + 4 B an edge, + 4 B of weight), with the edge offset of
// every `fine` destinations.  A source's row is its rank by out-degree
// (rank[v]), so that the rows of the sources most edges read lie together
// (on an RMAT graph a small share of the sources has most of the edges).
// One launch of fused_dc_interleave first writes the [lanes, M] tables
// lane-interleaved, [M, lanes] with entry v at row rank[v], and their
// validity as a bit mask a row, [M, ceil(lanes / 32)] words, so that an
// edge's lane values are one contiguous read (64 B for 16 four-byte lanes)
// and its validity one word.  Then one block of fused_dc_lanes folds `group`
// lanes (G: the largest power of two dividing `lanes`, at most 16) of a
// sub-slice of `width` destinations of one partition, a multiple of `fine`
// chosen by the wrapper so that its accumulators and touched flags, G *
// width of each, fit two blocks on an SM; the grid is k * ceil(q / width)
// blocks by lanes / G lane groups, and each group's blocks read the copy's
// edges once.  PE = G / V threads take one edge, each V of its lanes with
// one load (V = 4 four-byte or 2 eight-byte lanes, 16 bytes, where G
// allows), and the block's threads split the sub-slice's edges into
// contiguous spans, one a PE threads: they walk their span a batch of U
// edges at a time, each loading U / PE of the batch's edges and passing
// them on by shuffles, gather every edge's lane values and mask word before
// they fold any, and fold a run of one destination in registers, writing it
// to shared memory when the destination changes: by a plain
// read-modify-write where the run lies inside its span (no other thread
// holds that destination), by an atomic for its span's first and last runs.
// A hub's edges are one run, so its float adds take a few atomics, not one
// an edge.  Shared memory holds each lane's slice in a row padded by one
// word (touched: four bytes), so that the lanes folding into one destination
// hit different banks.  What bounds it: the gathers, one G-lane row of the
// [M, lanes] table (16 x 4 B, 268 MB at scale 22, past the 50 MB L2) an
// edge, beside the edge copy read once a lane group; the rank order lets
// L2 keep the rows most edges read.
//
// Precondition, checked once per layout (FusedDCKernel; the per-edge part on
// the card): part_tile_off is the destination-partition structure of the
// tiles, and every valid edge's global destination is p * q + dst_local with
// dst_local in [0, q).  An edge whose dst_local lies outside [0, q) folds
// nothing.
#include "edge_stream.cuh"
#include "fused_edges.cuh"
#include "partition_fold.cuh"

namespace {

using fused_edges::clamp_index;

template <typename T>
constexpr int kMaxChunk = fused_edges::kMaxChunk<T>;

// The single-lane entry's checks and dispatch.
int run(const void* table, const void* table_valid, long long table_len,
        const void* src_local, const void* dst_local, const void* valid,
        const void* w, const void* tile_src_part, const void* part_tile_off,
        int k, int q, int edge_tile, int chunk, long long num_segments,
        int monoid, int dtype, int edge_fn, void* acc, void* touched,
        void* stream) {
  if (k <= 0 || q <= 0 || edge_tile <= 0 || chunk <= 0 ||
      table_len <= 0 || num_segments < (long long)k * q)
    return (int)cudaErrorInvalidValue;
  const partition_fold::Parts parts{
      static_cast<const int*>(tile_src_part),
      static_cast<const long long*>(part_tile_off), k, q, edge_tile, chunk,
      0, num_segments};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    if (chunk > kMaxChunk<T>) return cudaErrorInvalidValue;
    return dispatch_edge<T>(edge_fn, [&](auto ef) -> cudaError_t {
      return fused_edges::launch<C::monoid, T, decltype(ef)::value, false>(
          table, table_valid, table_len, src_local, dst_local, valid, w,
          parts, acc, touched, s);
    });
  });
}

// ---- the lane form ----

constexpr int kInterleaveThreads = 256;   // vertices a block interleaves
constexpr int kInterleaveLanes = 16;      // lanes it moves through shared
                                          // memory at a time
constexpr int kLaneThreads = 512;
constexpr int kLaneEdges = 8;   // edges a thread takes before it gathers
                                // (of which each of an edge's threads
                                // loads its share)
constexpr int kMaxLaneGroup = 16;
constexpr int kLaneMaxLanes = 65535 * kMaxLaneGroup;   // gridDim.y groups

// Shared bytes of a lane block: `group` rows of width + 1 accumulators and
// width + 4 touched flags.
__host__ __device__ constexpr long long lane_bytes(int value_bytes, int group,
                                                   int width) {
  return (long long)group *
         ((long long)(width + 1) * value_bytes + width + 4);
}

// [lanes, table_len] tables (lane stride `stride`) and their validity to
// [table_len, lanes] and [table_len, words] bit masks, bit b of word w the
// validity of lane 32 * w + b, entry v's at row rank[v] (v without rank).
// Each block moves kInterleaveThreads entries: the mask a thread an entry,
// the tables kInterleaveLanes lanes at a time through shared memory, read
// along the entries and written along the lanes.
template <typename T>
__global__ void __launch_bounds__(kInterleaveThreads) interleave_kernel(
    const T* __restrict__ table, const uint8_t* __restrict__ valid,
    long long table_len, long long stride, int lanes, int words,
    const int* __restrict__ rank, T* __restrict__ out,
    uint32_t* __restrict__ mask) {
  __shared__ T s[kInterleaveThreads][kInterleaveLanes + 1];
  __shared__ long long s_row[kInterleaveThreads];
  const long long v0 = (long long)blockIdx.x * kInterleaveThreads;
  const long long v = v0 + threadIdx.x;
  const int nv = (int)min((long long)kInterleaveThreads, table_len - v0);
  if (v < table_len) {
    const long long row = rank != nullptr ? __ldg(rank + v) : v;
    s_row[threadIdx.x] = row;
    for (int wd = 0; wd < words; ++wd) {
      uint32_t bits = 0;
      const int top = min(32, lanes - 32 * wd);
      for (int b = 0; b < top; ++b)
        bits |= (uint32_t)(__ldg(valid + (32LL * wd + b) * stride + v) != 0)
                << b;
      mask[row * words + wd] = bits;
    }
  }
  for (int c = 0; c < lanes; c += kInterleaveLanes) {
    const int lc = min(kInterleaveLanes, lanes - c);
    if (v < table_len)
      for (int l = 0; l < lc; ++l)
        s[threadIdx.x][l] = __ldg(table + (long long)(c + l) * stride + v);
    __syncthreads();
    for (int f = threadIdx.x; f < nv * lc; f += kInterleaveThreads) {
      const int i = f / lc, l = f - i * lc;
      out[s_row[i] * lanes + c + l] = s[i][l];
    }
    __syncthreads();
  }
}

// A lane launch's arguments: the interleaved table and mask, the edge copy
// (src: global sources, dst: local destinations, w: weights or null; the
// edges of partition p's destinations [f * fine, (f + 1) * fine) are
// [off[p * n_fine + f], off[p * n_fine + f + 1])), and the outputs, lane b's
// at b * out_stride.
template <typename T>
struct LaneFold {
  const T* table;
  const uint32_t* mask;
  long long table_len;
  int lanes, words;
  const int* src;
  const int* dst;
  const float* w;
  const long long* off;
  int k, q, fine, n_fine, width, n_sub, group;
  long long num_segments, out_stride;
  T* acc;
  uint8_t* touched;
};

// V consecutive lanes of one table row, loaded as one 4-, 8- or 16-byte
// word.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ld_pack(const T* p) {
  Pack<T, V> r;
  if constexpr (sizeof(r) == 16)
    *reinterpret_cast<uint4*>(&r) = __ldg(reinterpret_cast<const uint4*>(p));
  else if constexpr (sizeof(r) == 8)
    *reinterpret_cast<uint2*>(&r) = __ldg(reinterpret_cast<const uint2*>(p));
  else
    *reinterpret_cast<uint32_t*>(&r) =
        __ldg(reinterpret_cast<const uint32_t*>(p));
  return r;
}

// A thread's fold of its V lanes over a span of destination-sorted edges:
// the current run's destination (-1: none), its values and which lanes it
// hit.
template <int M, typename T, int V>
struct LaneRun {
  int key = -1;
  T r[V];
  unsigned hit = 0;
  bool first = true;

  __device__ void reset(int k) {
    key = k;
    hit = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = identity<M, T>();
  }

  // The run into shared memory (lane v's row at s_acc + v * stride): an
  // atomic for the span's first and last runs, which another thread's
  // span may share, else a plain read-modify-write.
  __device__ void flush(T* s_acc, uint8_t* s_touched, int stride,
                        int t_stride, bool last) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if ((hit >> v) & 1u) {
        T* at = s_acc + v * stride + key;
        if (first || last) fold_into<M, T>(at, r[v]);
        else *at = combine<M, T>(*at, r[v]);
        s_touched[v * t_stride + key] = 1;
      }
    }
  }
};

// G lanes a block, V a thread (16-byte loads where G allows), PE = G / V
// threads an edge.
template <int M, typename T, int EF, int G>
__global__ void __launch_bounds__(kLaneThreads, 2)
    lane_fold_kernel(const LaneFold<T> a) {
  constexpr bool WEIGHT = EF != EDGE_NONE;
  constexpr int V = G < 16 / (int)sizeof(T) ? G : 16 / (int)sizeof(T);
  constexpr int PE = G / V;
  // edges a batch (fewer where 16-byte lane loads would not leave the
  // registers for more), of which each of an edge's threads loads L
  constexpr int U = V * sizeof(T) >= 16 && PE < kLaneEdges ? kLaneEdges / 2
                                                          : kLaneEdges;
  constexpr int L = U / PE;
  static_assert(U % PE == 0, "a batch's edges are shared by its threads");
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x / a.n_sub, j = blockIdx.x % a.n_sub;
  const int lo = j * a.width, wd = min(a.width, a.q - lo);
  const int f0 = lo / a.fine;
  const int f1 = min(f0 + a.width / a.fine, a.n_fine);
  const long long e0 = a.off[(long long)p * a.n_fine + f0];
  const long long e1 = a.off[(long long)p * a.n_fine + f1];
  // this thread's place in its edge's PE threads, its lanes (V of the
  // group from l0; of the call from lane), and the warp lane of the PE
  // threads' first
  const int t = threadIdx.x % PE;
  const int l0 = t * V;
  const int lane = blockIdx.y * G + l0;
  const int first_of_edge = (threadIdx.x & 31) - t;
  T* s_acc = reinterpret_cast<T*>(smem) + l0 * (wd + 1);
  uint8_t* s_flags = smem + (size_t)G * (wd + 1) * sizeof(T);
  uint8_t* s_touched = s_flags + l0 * (wd + 4);
  for (int i = threadIdx.x; i < G * (wd + 1); i += kLaneThreads)
    reinterpret_cast<T*>(smem)[i] = identity<M, T>();
  for (int i = threadIdx.x; i < G * (wd + 4); i += kLaneThreads)
    s_flags[i] = 0;
  __syncthreads();

  // every span has `per` edges but the last ones, and every thread of a
  // warp runs the same number of batches, so that the batch's shuffles see
  // the whole warp
  constexpr int spans = kLaneThreads / PE;
  const long long per = (e1 - e0 + spans - 1) / spans;
  const long long b0 = min(e1, e0 + threadIdx.x / PE * per);
  const long long b1 = min(e1, b0 + per);
  const T* tab = a.table + lane;
  const uint32_t* msk = a.mask + lane / 32;
  const int shift = lane % 32;
  LaneRun<M, T, V> run;
  run.reset(-1);
  for (long long e = b0; e < b0 + per; e += U) {
    // the batch's edges, loaded once between the PE threads that share them
    // (thread t loads edges t, t + PE, ...) and passed on by shuffles
    int my_src[L], my_dst[L];
    float my_w[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const long long x = e + i * PE + t;
      my_src[i] = 0;
      my_dst[i] = -1;
      my_w[i] = 0.0f;
      if (x < b1) {
        my_src[i] = __ldg(a.src + x);
        my_dst[i] = __ldg(a.dst + x) - lo;
        if constexpr (WEIGHT) my_w[i] = __ldg(a.w + x);
      }
    }
    int src[U], key[U];
    float w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int from = first_of_edge + u % PE;
      const int d = PE == 1 ? my_dst[u]
                            : __shfl_sync(0xffffffffu, my_dst[u / PE], from);
      src[u] = PE == 1 ? my_src[u]
                       : __shfl_sync(0xffffffffu, my_src[u / PE], from);
      w[u] = 0.0f;
      if constexpr (WEIGHT)
        w[u] = PE == 1 ? my_w[u]
                       : __shfl_sync(0xffffffffu, my_w[u / PE], from);
      key[u] = (unsigned)d < (unsigned)wd && e + u < b1 ? d : -1;
    }
    Pack<T, V> v[U];
    uint32_t m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      m[u] = 0;
      if (key[u] >= 0) {
        const long long si = clamp_index(src[u], a.table_len);
        m[u] = __ldg(msk + si * a.words) >> shift;
        v[u] = ld_pack<T, V>(tab + si * a.lanes);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e + u >= b1) break;
      if (key[u] != run.key) {
        run.flush(s_acc, s_touched, wd + 1, wd + 4, false);
        run.first = run.first && run.key == -1 && run.hit == 0;
        run.reset(key[u]);
      }
#pragma unroll
      for (int x = 0; x < V; ++x) {
        if ((m[u] >> x) & 1u) {
          run.r[x] = combine<M, T>(run.r[x], apply_edge<EF>(v[u].x[x], w[u]));
          run.hit |= 1u << x;
        }
      }
    }
  }
  run.flush(s_acc, s_touched, wd + 1, wd + 4, true);
  __syncthreads();

  for (int i = threadIdx.x; i < G * wd; i += kLaneThreads) {
    const int gl = i / wd, x = i - gl * wd;
    const long long at = (long long)(blockIdx.y * G + gl) * a.out_stride +
                         (long long)p * a.q + lo + x;
    a.acc[at] = reinterpret_cast<const T*>(smem)[gl * (wd + 1) + x];
    a.touched[at] = s_flags[gl * (wd + 4) + x];
  }
  if (blockIdx.x == 0) {   // segments [k*q, num_segments): the identity
    const long long tail = a.num_segments - (long long)a.k * a.q;
    for (long long i = threadIdx.x; i < G * tail; i += kLaneThreads) {
      const long long gl = i / tail;
      const long long at = (blockIdx.y * G + gl) * a.out_stride +
                           (long long)a.k * a.q + (i - gl * tail);
      a.acc[at] = identity<M, T>();
      a.touched[at] = 0;
    }
  }
}

// The lane form's launch: dispatch by monoid, type and edge function, raise
// the shared-memory limit and launch k * n_sub blocks by lanes / group.
int run_lanes(const LaneFold<void>& base, int monoid, int dtype, int edge_fn,
              cudaStream_t stream) {
  return (int)dispatch_combo(monoid, dtype, [&](auto combo) -> cudaError_t {
    using C = decltype(combo);
    using T = typename C::type;
    const long long smem = lane_bytes(sizeof(T), base.group, base.width);
    if (smem > partition_fold::kMaxSmem) return cudaErrorInvalidValue;
    return dispatch_edge<T>(edge_fn, [&](auto ef) -> cudaError_t {
      constexpr int EF = decltype(ef)::value;
      if (EF != EDGE_NONE && base.w == nullptr) return cudaErrorInvalidValue;
      const LaneFold<T> a{static_cast<const T*>(base.table), base.mask,
                          base.table_len, base.lanes, base.words, base.src,
                          base.dst, base.w, base.off, base.k, base.q,
                          base.fine, base.n_fine, base.width, base.n_sub,
                          base.group, base.num_segments, base.out_stride,
                          static_cast<T*>(base.acc), base.touched};
      auto launch = [&](auto group) -> cudaError_t {
        constexpr int G = decltype(group)::value;
        auto kernel = lane_fold_kernel<C::monoid, T, EF, G>;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err == cudaSuccess)   // two blocks an SM need all its shared
          err = cudaFuncSetAttribute(   // memory
              kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
              cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
        kernel<<<dim3((unsigned)(base.k * base.n_sub),
                      (unsigned)(base.lanes / base.group)),
                 kLaneThreads, smem, stream>>>(a);
        return cudaGetLastError();
      };
      switch (base.group) {
        case 1: return launch(std::integral_constant<int, 1>{});
        case 2: return launch(std::integral_constant<int, 2>{});
        case 4: return launch(std::integral_constant<int, 4>{});
        case 8: return launch(std::integral_constant<int, 8>{});
        case 16: return launch(std::integral_constant<int, 16>{});
        default: return cudaErrorInvalidValue;
      }
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
  return run(table, table_valid, table_len, src_local, dst_local, valid, w,
             tile_src_part, part_tile_off, k, q, edge_tile, chunk,
             num_segments, monoid, dtype, edge_fn, acc, touched, stream);
}

// The lane form's first launch: `lanes` tables of table_len entries of
// value_bytes (4 or 8) bytes, lane b's (and its validity's) at b *
// table_stride (>= table_len), written to table_il [table_len, lanes] and to
// mask [table_len, ceil(lanes / 32)] uint32 words, bit lane % 32 of word
// lane / 32 set where lane's entry is valid; entry v at row rank[v] (rank:
// int32 [table_len], a permutation; null: row v).  1 <= lanes <= 1,048,560.
extern "C" int fused_dc_interleave(const void* table, const void* table_valid,
                                   long long table_len,
                                   long long table_stride, int lanes,
                                   int value_bytes, const void* rank,
                                   void* table_il, void* mask, void* stream) {
  if (table_len <= 0 || lanes < 1 || lanes > kLaneMaxLanes ||
      table_stride < table_len || (value_bytes != 4 && value_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (table_len + kInterleaveThreads - 1) / kInterleaveThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* valid = static_cast<const uint8_t*>(table_valid);
  const int words = (lanes + 31) / 32;
  uint32_t* m = static_cast<uint32_t*>(mask);
  const int* r = static_cast<const int*>(rank);
  if (value_bytes == 8)
    interleave_kernel<unsigned long long>
        <<<(unsigned)blocks, kInterleaveThreads, 0, s>>>(
            static_cast<const unsigned long long*>(table), valid, table_len,
            table_stride, lanes, words, r,
            static_cast<unsigned long long*>(table_il), m);
  else
    interleave_kernel<uint32_t>
        <<<(unsigned)blocks, kInterleaveThreads, 0, s>>>(
            static_cast<const uint32_t*>(table), valid, table_len,
            table_stride, lanes, words, r, static_cast<uint32_t*>(table_il),
            m);
  return (int)cudaGetLastError();
}

// The lane form's fold: `lanes` tables interleaved by fused_dc_interleave
// (table_il, mask) folded over the destination-sorted edge copy (src: each
// edge's source row of table_il, clamped into [0, table_len) here; dst: its
// destination within its partition; w: weights, read when edge_fn is not
// EDGE_NONE; off: int64 [k * ceil(q / fine) + 1], partition p's
// destinations [f * fine, (f + 1) * fine) holding edges [off[p * n_fine +
// f], off[p * n_fine + f + 1]), each destination's edges consecutive) into
// lane b's acc and touched at b * out_stride (>= num_segments >= k*q);
// segments [k*q, num_segments) get the identity, untouched.  A block folds
// `group` lanes (1, 2, 4, 8 or 16, dividing lanes, lanes / group <= 65,535)
// of `width` destinations (a multiple of fine, group * ((width + 1) * value
// bytes + width + 4) bytes of shared memory at most 232,448).  Monoids,
// types and edge functions as fused_dc.
extern "C" int fused_dc_lanes(const void* table_il, const void* mask,
                              long long table_len, int lanes,
                              const void* src, const void* dst,
                              const void* w, const void* off, int k, int q,
                              int fine, int width, int group,
                              long long num_segments, long long out_stride,
                              int monoid, int dtype, int edge_fn, void* acc,
                              void* touched, void* stream) {
  if (table_len <= 0 || k <= 0 || q <= 0 || fine <= 0 || width <= 0 ||
      width % fine != 0 || group < 1 || group > kMaxLaneGroup ||
      lanes < 1 || lanes % group != 0 || lanes / group > 65535 ||
      num_segments < (long long)k * q || out_stride < num_segments)
    return (int)cudaErrorInvalidValue;
  const int n_fine = (q + fine - 1) / fine;
  const int n_sub = (q + width - 1) / width;
  if ((long long)k * n_sub > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const LaneFold<void> base{
      table_il, static_cast<const uint32_t*>(mask), table_len, lanes,
      (lanes + 31) / 32, static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const float*>(w),
      static_cast<const long long*>(off), k, q, fine, n_fine, width, n_sub,
      group, num_segments, out_stride, acc, static_cast<uint8_t*>(touched)};
  return run_lanes(base, monoid, dtype, edge_fn,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* fused_dc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
