// A ring of shared-memory stages that streams one destination partition's
// edge tiles into a thread block, for the destination-major kernels
// (spmv_block.cu, segment_combine.cu, fused_dc.cu, fused_stream.cu).
//
// Why: a kernel that reads its edges with plain loads has as many bytes in
// flight as its threads have loads outstanding, and a load that waits on a
// branch or on another load keeps that number low.  Here one producer warp
// keeps STAGES stages of up to STAGE_EDGES edges each in flight with
// asynchronous bulk copies (cp.async.bulk, the 1-D form of the Tensor Memory
// Accelerator), and the consumer warps read arrived stages from shared
// memory.  At 13 B an edge (spmv_block weighted) a stage of 2048 edges is
// 26 KB, so one block keeps up to 80 KB in flight; 128 blocks keep 10 MB, a
// few times what 3.35 TB/s at about a microsecond of latency needs (Little's
// law).  The producer takes a run of consecutive live tiles in one step, not
// one tile, so that its own work per stage does not set the stream's rate.
//
// The stage geometry is a template parameter, so that a kernel that keeps
// more of its shared memory for accumulators (fused_dc.cu weighted) can take
// a smaller ring.
//
// What a stage holds: a run of up to STAGE_EDGES edges of the partition's
// live tiles, in tile order, as up to kMaxArrays per-edge arrays (element
// sizes 1, 2, 4 or 8 bytes), plus each 16-edge group's tag (the tile's
// tile_src_part entry) and the stage's edge count.  A tile is live when the
// caller's predicate on its tag says so; a dead tile costs no edge bytes.
// Runs of consecutive live tiles go in one copy per array; a stage closes
// early after kMaxPieces runs.  A count of 0 ends the stream.
//
// TMA rules: a bulk copy moves a multiple of 16 bytes between 16-byte-aligned
// addresses.  So every array's base must be 16-byte aligned and edge_tile a
// multiple of 16 (edge_stream_ok); then every run starts at an edge index
// that is a multiple of 16 and spans a multiple of 16 edges.  The tuner's
// edge tiles (128 to 1024) and the defaults all are.
//
// Protocol: full[s] completes when the producer has arrived (after writing
// the stage's tags and count) and the stage's bytes have landed; empty[s]
// completes when each consumer warp has released stage s.  The producer
// waits on empty with the opposite parity first, so its first pass over the
// ring does not wait.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace edge_stream {

constexpr int kGroup = 16;                  // edges per tag; TMA granule
constexpr int kMaxArrays = 4;
constexpr int kMaxPieces = 32;              // runs per stage: one per lane

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

// True when the arrays and edge_tile meet the bulk copies' rules.
inline bool edge_stream_ok(const void* const* arrays, int n_arrays,
                           int edge_tile) {
  if (edge_tile <= 0 || edge_tile % kGroup != 0) return false;
  for (int a = 0; a < n_arrays; ++a)
    if (reinterpret_cast<uintptr_t>(arrays[a]) % 16 != 0) return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The ring's view of shared memory and of the edge arrays it streams:
// STAGES stages of up to STAGE_EDGES edges.
template <int STAGES, int STAGE_EDGES>
struct Ring {
  static constexpr int kStages = STAGES;
  static constexpr int kStageEdges = STAGE_EDGES;
  static constexpr int kGroups = STAGE_EDGES / kGroup;
  static_assert(STAGE_EDGES % kGroup == 0, "stages hold whole groups");

  // Shared-memory bytes of a ring whose edges take bytes_per_edge bytes.
  __host__ __device__ static constexpr int bytes(int bytes_per_edge) {
    return kStages * kStageEdges * bytes_per_edge     // stage data
           + kStages * kGroups * 4                    // tags
           + align16(kStages * 4)                     // counts
           + 2 * kStages * 8;                         // full, empty barriers
  }

  unsigned char* data;   // [kStages][stage_bytes]
  int* tag;              // [kStages][kGroups]
  int* count;            // [kStages]
  uint64_t* full;        // [kStages]
  uint64_t* empty;       // [kStages]
  const unsigned char* src[kMaxArrays];
  int elem[kMaxArrays];
  int offset[kMaxArrays];  // byte offset of array a inside a stage
  int n_arrays;
  int bytes_per_edge;

  // Lays the ring out at `base` (16-byte aligned, bytes() long).
  __device__ Ring(unsigned char* base, int n, const void* const* arrays,
                  const int* elems) {
    n_arrays = n;
    bytes_per_edge = 0;
    for (int a = 0; a < n; ++a) {
      src[a] = static_cast<const unsigned char*>(arrays[a]);
      elem[a] = elems[a];
      offset[a] = kStageEdges * bytes_per_edge;
      bytes_per_edge += elems[a];
    }
    data = base;
    tag = reinterpret_cast<int*>(data + kStages * kStageEdges *
                                            bytes_per_edge);
    count = tag + kStages * kGroups;
    full = reinterpret_cast<uint64_t*>(
        reinterpret_cast<unsigned char*>(count) + align16(kStages * 4));
    empty = full + kStages;
  }

  // One thread; the block then needs a __syncthreads() before any use.
  __device__ void init(int consumer_warps) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  template <typename T>
  __device__ const T* array(int s, int a) const {
    return reinterpret_cast<const T*>(data + s * kStageEdges * bytes_per_edge +
                                      offset[a]);
  }

  // Consumer side, whole warp: wait for stage s of the pass with parity
  // `phase`; returns its edge count (0: the stream has ended).
  __device__ int wait(int s, uint32_t phase) const {
    mbar_wait(&full[s], phase);
    return count[s];
  }

  // Consumer side, whole warp, after its last read of stage s.
  __device__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
  }

  // Producer side, one whole warp: stream tiles [t0, t1) of edge_tile edges,
  // skipping each tile whose tag (tile_tag[t]; 0 unless TAGGED, and then
  // tile_tag is not read) fails live(tag), then end the stream.
  // Tiles are taken 32 at a time (their tags read in one load, the next 32
  // prefetched); within those, each run of consecutive live tiles goes into
  // a stage in one step, so the warp's work per stage does not grow with the
  // number of tiles it holds.
  template <bool TAGGED = true, typename Live>
  __device__ void produce(const int* __restrict__ tile_tag, long long t0,
                          long long t1, int edge_tile, Live live) {
    const int lane = threadIdx.x & 31;
    const unsigned all = 0xffffffffu;
    long long batch = t0 - 32;   // first tile of the current 32
    int tag_lane = -1;           // this lane's tile's tag in the current 32
    auto tag_of = [&](long long t) {
      if constexpr (TAGGED) return tile_tag[t];
      else return 0;
    };
    int tag_next = t0 + lane < t1 ? tag_of(t0 + lane) : -1;
    unsigned pending = 0;        // live tiles of the current 32 not begun
    int cur = -1;                // tile being copied (index in the 32)
    int cur_off = 0;             // its edges already copied
    int s = 0;
    uint32_t phase = 1;
    for (;;) {
      mbar_wait(&empty[s], phase);
      int n = 0, pieces = 0;
      long long run_end = -1;
      long long my_e = 0;   // lane i holds piece i: first edge, length, slot
      int my_len = 0, my_slot = 0;
      while (n < kStageEdges) {
        if (cur < 0) {
          while (pending == 0 && batch < t1) {
            batch += 32;
            tag_lane = tag_next;
            const long long tn = batch + 32 + lane;
            tag_next = tn < t1 ? tag_of(tn) : -1;
            pending = __ballot_sync(all, batch + lane < t1 && live(tag_lane));
          }
          if (pending == 0) break;
          cur = __ffs(pending) - 1;
          pending &= pending - 1;
          cur_off = 0;
        }
        // the live tiles that follow cur without a gap, in these 32
        const unsigned above = cur == 31 ? 0u : pending >> (cur + 1);
        const int run = __ffs(~above) - 1;
        const int len = min(edge_tile - cur_off + run * edge_tile,
                            kStageEdges - n);
        const long long e = (batch + cur) * edge_tile + cur_off;
        const bool extend = e == run_end;
        if (!extend && pieces == kMaxPieces) break;
        for (int g0 = 0; g0 < len / kGroup; g0 += 32) {
          const int g = g0 + lane;
          const int t = cur + (cur_off + g * kGroup) / edge_tile;
          const int tg = __shfl_sync(all, tag_lane, t & 31);
          if (g < len / kGroup) tag[s * kGroups + n / kGroup + g] = tg;
        }
        if (extend) {
          if (lane == pieces - 1) my_len += len;
        } else {
          if (lane == pieces) { my_e = e; my_len = len; my_slot = n; }
          ++pieces;
        }
        run_end = e + len;
        n += len;
        // tiles cur+1 .. last are now begun; cur moves to the last one,
        // or to none when the copy ended on a tile boundary
        const int pos = cur_off + len;
        const int last = cur + (pos - 1) / edge_tile;
        if (last > cur) pending &= ~((2u << last) - (2u << cur));
        cur_off = pos - (last - cur) * edge_tile;
        cur = last;
        if (cur_off == edge_tile) cur = -1;
      }
      if (lane == 0) count[s] = n;
      __syncwarp();
      if (lane == 0) {
        if (n == 0) mbar_arrive(&full[s]);
        else mbar_arrive_expect_tx(&full[s], (uint32_t)n * bytes_per_edge);
      }
      if (n == 0) return;
      __syncwarp();
      if (lane < pieces) {
        unsigned char* stage = data + s * kStageEdges * bytes_per_edge;
        for (int a = 0; a < n_arrays; ++a)
          bulk_copy(stage + offset[a] + my_slot * elem[a],
                    src[a] + my_e * elem[a], (uint32_t)my_len * elem[a],
                    &full[s]);
      }
      if (++s == kStages) { s = 0; phase ^= 1; }
    }
  }
};

}  // namespace edge_stream
