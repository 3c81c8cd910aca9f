// The DC scatter on Hopper: write each PNG message slot's value into the bins.
//
// Replaces the Pallas kernel repro.kernels.dc_gather.dc_gather
// (src/repro/kernels/dc_gather.py:62).  Python side:
// repro_torch/kernels/dc_gather.py (dc_gather_cuda, dc_pieces).
//
// Slot s of the [NM] bins gets x[p * q + png_src_local[s]], with
// p = png_tile_part[s / msg_tile] the source partition of its slot tile, when
// png_valid[s] and that source is active, and the monoid identity otherwise.
// A source outside [0, k*q) (a malformed layout) writes the identity.  The
// output is a pure select of words, so the kernel moves bits (uint32, or
// unsigned long long for the 8-byte packed words of min_with_payload) and
// takes the identity's bit pattern from the wrapper; one kernel serves every
// monoid and dtype of a width.
//
// What bounds it on this card: bytes.  Each slot reads png_src_local (4 B)
// and png_valid (1 B) and writes its value (4 B); png_tile_part is one word
// per msg_tile slots; the [k, q] value and activity tables add 5 B a vertex.
// At RMAT scale 22 that is 274.5 MB, 0.082 ms at 3.35 TB/s.  What the bound
// leaves out: each slot's source is a random read.  Within a bin the slots
// hold ascending sources about q / (slots per bin) apart (about 19 at scale
// 22), so read through L2 each slot costs about one 32-byte sector of x and
// half a sector of active: some 50 B of L2 traffic beside its 9 B of stream.
// Eight-byte words move 13 B a slot and 9 B a vertex (0.121 ms at scale 22).
//
// Design: two regimes, chosen here by shape; the staged one has a form for
// each word width.
//
//   * staged (the TPU kernel's BlockSpec, which keeps the source partition's
//     rows in VMEM): the wrapper passes pieces, runs of consecutive slot
//     tiles that share one source partition (dc_pieces on the host, once per
//     layout).  One block takes one piece: one thread copies the partition's
//     rows x[p, :] and active[p, :] (5q B) into shared memory with two bulk
//     asynchronous copies (cp.async.bulk, completing on an mbarrier), and
//     the block streams its slots meanwhile: each thread loads its first
//     slots before it waits for the rows, then reads every source from shared
//     memory.  The rows arrive while the block checks that every tile of its
//     piece names the piece's partition; a piece that fails the check (pieces
//     built for another png_tile_part, or a partition outside [0, k)) takes
//     the L2 regime's loop for its slots, so any pieces that cover the tiles
//     once give the same bins.  Needs q % 16 == 0 (rows start and end on
//     16-byte boundaries), x and active 16-byte aligned, 4-byte words, and
//     5q + 8 B of shared memory: q <= 46,480 (kMaxStagedQ).  At q = 32,768 a
//     block takes 163,848 B, so one block per SM, 1,024 threads.
//   * staged, 8-byte words (halves_kernel): 9q + 8 B of rows (294,920 B at
//     q = 32,768) do not fit a block, so two blocks take a piece, block h
//     staging half h of the rows, x[p, h*q/2 : (h+1)*q/2] and active's
//     (4.5q + 8 B: 147,464 B at q = 32,768), by the same bulk copies.  Both
//     stream all of the piece's slots and each writes only the slots whose
//     source lies in its half (block 0 also those whose source lies outside
//     [0, q), with the identity): within a bin the sources ascend, so each
//     block writes runs.  The two blocks of a piece, and a piece's lanes in
//     the lane form, are neighbours in launch order, so the slot stream's
//     second read (5 B a slot) comes from L2.  Needs q % 32 == 0 (a half
//     row starts and ends on 16-byte boundaries in both arrays) and q <=
//     51,648 (kMaxHalvesQ); the partition check and its L2 loop as above,
//     the piece's slots split between its two blocks.
//   * L2 (no pieces, or a shape the staged regime cannot take): a grid-stride
//     loop over the slots that reads each source through L2.  Both of a
//     slot's reads (x and active) are issued before either is used, and the
//     slot stream is read and written with evict-first hints, so that x and
//     active stay in L2.
//
// The lane form (dc_gather_lanes, the batched engine's composed step): the
// bins of `lanes` inputs [lanes, k*q] in one launch, lane b's blocks on
// blockIdx.y == b (in the 8-byte staged regime, on blockIdx.x % lanes),
// each as a single-lane launch's block on lane b's x, active and out; in
// the staged regime each lane's blocks stage that lane's rows.  Lanes share
// the slot stream, which each lane's blocks read again (the 8-byte staged
// regime runs a piece's lanes one after another in launch order, lane
// fastest, so that those reads come from L2).
//
// How a thread takes its slots.  Staged: four consecutive slots at a time
// (a 16-byte load of png_src_local, a 4-byte load of png_valid, a 16-byte
// store) where msg_tile % 4 == 0 and those arrays are aligned, so four
// slots never straddle a tile; one at a time otherwise; kUnroll of either
// loaded before the thread selects.  Eight-byte words: two slots at a time
// (8-byte, 2-byte and 16-byte accesses; one 8-byte store for a slot of the
// pair that the other half's block writes) where msg_tile is even and the
// arrays are aligned, else one.  L2: one slot a pass, thread t of T
// taking t, t + T, ..., so that each gather instruction of a warp covers 32
// consecutive slots, whose sources lie close together in one row.  Measured
// at RMAT scale 22 on an H100 (PERF.md), more slots a thread made the L2
// regime slower, not faster: two or eight in flight 2 % and 27 % slower, four
// consecutive ones (whose 32 sources an instruction spreads four times as
// wide) 66 % slower.  Slot indices are 32-bit where nm allows; only the L2
// regime divides (by msg_tile, for a slot's tile).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "edge_stream.cuh"

namespace {

using edge_stream::bulk_copy;
using edge_stream::mbar_arrive_expect_tx;
using edge_stream::mbar_init;
using edge_stream::mbar_wait;

constexpr int kStagedThreads = 1024;
constexpr int kL2Threads = 256;
constexpr int kL2BlocksPerSM = 8;
constexpr int kUnroll = 4;   // staged: slots (four-slot groups with VEC)
                             // a thread loads before it waits or selects
constexpr int kMaxSmem = 232448;     // a block's dynamic shared memory
constexpr int kMaxStagedQ = 46480;   // largest q % 16 == 0 with 5q + 8 <= it
constexpr int kMaxHalvesQ = 51648;   // largest q % 32 == 0 with 4.5q + 8 <= it
constexpr int kRegimeL2 = 0, kRegimeStaged = 1;
constexpr int kMaxLanes = 65535;     // gridDim.y

// Shared bytes of the staged regime: x's row, active's row, the mbarrier.
__host__ __device__ constexpr long long staged_bytes(long long q) {
  return 5 * q + 8;
}
static_assert(staged_bytes(kMaxStagedQ) <= kMaxSmem &&
                  staged_bytes(kMaxStagedQ + 16) > kMaxSmem &&
                  kMaxStagedQ % 16 == 0,
              "kMaxStagedQ is the widest row pair one block can stage");

// Shared bytes of the 8-byte staged regime: half of x's row and of active's
// (q / 2 words and bytes), the mbarrier.
__host__ __device__ constexpr long long halves_bytes(long long q) {
  return 4 * q + q / 2 + 8;
}
static_assert(halves_bytes(kMaxHalvesQ) <= kMaxSmem &&
                  halves_bytes(kMaxHalvesQ + 32) > kMaxSmem &&
                  kMaxHalvesQ % 32 == 0,
              "kMaxHalvesQ is the widest q whose half rows one block can "
              "stage");

// W: the word moved, uint32_t or unsigned long long.
template <typename W>
struct Args {
  const W* x;
  const uint8_t* active;
  const int* src_local;
  const uint8_t* valid;
  const int* tile_part;
  W* out;
  int k, q, msg_tile;
  W ident;
  long long x_stride, out_stride;   // entries between two lanes' x (and
                                    // active), and their out

  // Lane b's x, active and out.
  __device__ void to_lane(long long b) {
    x += b * x_stride;
    active += b * x_stride;
    out += b * out_stride;
  }
};

// Read-only gathers that the compiler may neither drop nor predicate on each
// other, so that a slot's two reads go out together.
__device__ __forceinline__ uint32_t ld_word(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.global.nc.u64 %0, [%1];\n" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ld_u8(const uint8_t* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u8 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

// One slot through L2.  `ok` is its png_valid byte.
template <typename W>
__device__ __forceinline__ W slot_l2(const Args<W>& a, int part, int local,
                                     uint32_t ok) {
  const bool inside = (unsigned)local < (unsigned)a.q &&
                      (unsigned)part < (unsigned)a.k;
  const long long src = inside ? (long long)part * a.q + local : 0;
  const uint32_t act = ld_u8(a.active + src);
  const W v = ld_word(a.x + src);
  return ok != 0 && act != 0 && inside ? v : a.ident;
}

// One slot from the staged rows.
__device__ __forceinline__ uint32_t slot_staged(const Args<uint32_t>& a,
                                                const uint32_t* s_x,
                                                const uint8_t* s_act,
                                                int local, uint32_t ok) {
  const bool inside = (unsigned)local < (unsigned)a.q;
  const int i = inside ? local : 0;
  return ok != 0 && s_act[i] != 0 && inside ? s_x[i] : a.ident;
}

// Slots [s0, s1) through L2: thread `tid` of `nthreads` takes slots tid,
// tid + nthreads, ..., one per pass, so that each gather instruction of a
// warp covers 32 consecutive slots.
template <typename W, typename Index>
__device__ void l2_range(const Args<W>& a, Index s0, Index s1, Index tid,
                         Index nthreads) {
  const Index mt = (Index)a.msg_tile;
  for (Index s = s0 + tid; s < s1; s += nthreads) {
    const int local = __ldcs(a.src_local + s);
    const uint32_t ok = __ldcs(a.valid + s);
    const int part = __ldg(a.tile_part + s / mt);
    __stcs(a.out + s, slot_l2(a, part, local, ok));
  }
}

// With LANES, a block first moves a to its lane (blockIdx.y); the
// single-lane instantiations carry no lane offsets.
template <typename W, typename Index, bool LANES>
__global__ void __launch_bounds__(kL2Threads) l2_kernel(Args<W> a, Index nm) {
  if constexpr (LANES) a.to_lane(blockIdx.y);
  l2_range<W, Index>(a, 0, nm, (Index)blockIdx.x * kL2Threads + threadIdx.x,
                  (Index)gridDim.x * kL2Threads);
}

// One block per piece: tiles [piece_tiles[b], piece_tiles[b + 1]).  With
// VEC, a thread takes four consecutive slots at a time.
template <typename Index, bool VEC, bool LANES>
__global__ void __launch_bounds__(kStagedThreads, 1)
    staged_kernel(Args<uint32_t> a,
                  const long long* __restrict__ piece_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (LANES) a.to_lane(blockIdx.y);
  const long long t0 = piece_tiles[blockIdx.x];
  const long long t1 = piece_tiles[blockIdx.x + 1];
  if (t1 <= t0) return;
  const int q = a.q;
  uint32_t* s_x = reinterpret_cast<uint32_t*>(smem);
  uint8_t* s_act = smem + 4 * (size_t)q;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 5 * (size_t)q);
  const int part = __ldg(a.tile_part + t0);
  const bool live = (unsigned)part < (unsigned)a.k;
  if (threadIdx.x == 0 && live) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && live) {
    mbar_arrive_expect_tx(bar, 5u * (uint32_t)q);
    bulk_copy(s_x, a.x + (size_t)part * q, 4u * (uint32_t)q, bar);
    bulk_copy(s_act, a.active + (size_t)part * q, (uint32_t)q, bar);
  }
  // while the rows are in flight: does every tile name this partition?
  int same = 1;
  for (long long t = t0 + threadIdx.x; t < t1; t += kStagedThreads)
    same &= __ldg(a.tile_part + t) == part;
  const bool staged = __syncthreads_and(same) && live;
  const Index s0 = (Index)(t0 * a.msg_tile), s1 = (Index)(t1 * a.msg_tile);
  if (!staged) {
    l2_range<uint32_t, Index>(a, s0, s1, threadIdx.x, kStagedThreads);
    if (live) mbar_wait(bar, 0);   // no copy may land after the block ends
    return;
  }
  // each thread loads its first slots, then waits for the rows
  bool arrived = false;
  if constexpr (VEC) {
    const int4* loc4 = reinterpret_cast<const int4*>(a.src_local);
    const uint32_t* ok4 = reinterpret_cast<const uint32_t*>(a.valid);
    uint4* out4 = reinterpret_cast<uint4*>(a.out);
    const Index g1 = s1 / 4;
    for (Index g0 = s0 / 4 + threadIdx.x; g0 < g1;
         g0 += kStagedThreads * kUnroll) {
      int4 l[kUnroll];
      uint32_t ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Index g = g0 + u * kStagedThreads;
        if (g < g1) {
          l[u] = __ldcs(loc4 + g);
          ok[u] = __ldcs(ok4 + g);
        }
      }
      if (!arrived) {
        mbar_wait(bar, 0);
        arrived = true;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Index g = g0 + u * kStagedThreads;
        if (g < g1) {
          uint4 v;
          v.x = slot_staged(a, s_x, s_act, l[u].x, ok[u] & 0xffu);
          v.y = slot_staged(a, s_x, s_act, l[u].y, (ok[u] >> 8) & 0xffu);
          v.z = slot_staged(a, s_x, s_act, l[u].z, (ok[u] >> 16) & 0xffu);
          v.w = slot_staged(a, s_x, s_act, l[u].w, ok[u] >> 24);
          __stcs(out4 + g, v);
        }
      }
    }
  } else {
    for (Index f = s0 + threadIdx.x; f < s1; f += kStagedThreads * kUnroll) {
      int l[kUnroll];
      uint32_t ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Index s = f + u * kStagedThreads;
        if (s < s1) {
          l[u] = __ldcs(a.src_local + s);
          ok[u] = __ldcs(a.valid + s);
        }
      }
      if (!arrived) {
        mbar_wait(bar, 0);
        arrived = true;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Index s = f + u * kStagedThreads;
        if (s < s1)
          __stcs(a.out + s, slot_staged(a, s_x, s_act, l[u], ok[u]));
      }
    }
  }
  if (!arrived) mbar_wait(bar, 0);
}

using U64 = unsigned long long;

// A slot of the 8-byte staged regime: whether block `h` (whose half starts
// at `base`) writes it, and with what.  A source outside [0, q) is block
// 0's, with the identity.
struct HalfSlot {
  bool mine;
  U64 v;
};

__device__ __forceinline__ HalfSlot slot_half(const Args<U64>& a,
                                              const U64* s_x,
                                              const uint8_t* s_act, int local,
                                              uint32_t ok, int h, int base,
                                              int half) {
  const bool inside = (unsigned)local < (unsigned)a.q;
  const int i = local - base;
  HalfSlot r;
  r.mine = inside ? (unsigned)i < (unsigned)half : h == 0;
  const int j = r.mine && inside ? i : 0;
  r.v = ok != 0 && inside && s_act[j] != 0 ? s_x[j] : a.ident;
  return r;
}

// Two blocks per piece and lane: block (2 * piece + h) * lanes + lane stages
// half h of lane `lane`'s rows of the piece's partition and writes the
// piece's slots whose source lies there.  With VEC, a thread takes two
// consecutive slots at a time.
template <typename Index, bool VEC>
__global__ void __launch_bounds__(kStagedThreads, 1)
    halves_kernel(Args<U64> a, const long long* __restrict__ piece_tiles,
                  int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned pair = blockIdx.x / (unsigned)lanes;
  a.to_lane(blockIdx.x % (unsigned)lanes);
  const int h = pair & 1;
  const long long t0 = piece_tiles[pair >> 1];
  const long long t1 = piece_tiles[(pair >> 1) + 1];
  if (t1 <= t0) return;
  const int q = a.q, half = q / 2, base = h * half;
  U64* s_x = reinterpret_cast<U64*>(smem);
  uint8_t* s_act = smem + 8 * (size_t)half;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 9 * (size_t)half);
  const int part = __ldg(a.tile_part + t0);
  const bool live = (unsigned)part < (unsigned)a.k;
  if (threadIdx.x == 0 && live) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && live) {
    const size_t row = (size_t)part * q + base;
    mbar_arrive_expect_tx(bar, 9u * (uint32_t)half);
    bulk_copy(s_x, a.x + row, 8u * (uint32_t)half, bar);
    bulk_copy(s_act, a.active + row, (uint32_t)half, bar);
  }
  int same = 1;
  for (long long t = t0 + threadIdx.x; t < t1; t += kStagedThreads)
    same &= __ldg(a.tile_part + t) == part;
  const bool staged = __syncthreads_and(same) && live;
  const Index s0 = (Index)(t0 * a.msg_tile), s1 = (Index)(t1 * a.msg_tile);
  if (!staged) {   // the piece's slots through L2, split between its blocks
    l2_range<U64, Index>(a, s0, s1, (Index)(h * kStagedThreads + threadIdx.x),
                         (Index)(2 * kStagedThreads));
    if (live) mbar_wait(bar, 0);
    return;
  }
  bool arrived = false;
  if constexpr (VEC) {
    const int2* loc2 = reinterpret_cast<const int2*>(a.src_local);
    const unsigned short* ok2 =
        reinterpret_cast<const unsigned short*>(a.valid);
    ulonglong2* out2 = reinterpret_cast<ulonglong2*>(a.out);
    const Index g1 = s1 / 2;
    for (Index g0 = s0 / 2 + threadIdx.x; g0 < g1;
         g0 += kStagedThreads * kUnroll) {
      int2 l[kUnroll];
      uint32_t ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Index g = g0 + u * kStagedThreads;
        if (g < g1) {
          l[u] = __ldcs(loc2 + g);
          ok[u] = __ldcs(ok2 + g);
        }
      }
      if (!arrived) {
        mbar_wait(bar, 0);
        arrived = true;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Index g = g0 + u * kStagedThreads;
        if (g < g1) {
          const HalfSlot x = slot_half(a, s_x, s_act, l[u].x, ok[u] & 0xffu,
                                       h, base, half);
          const HalfSlot y = slot_half(a, s_x, s_act, l[u].y, ok[u] >> 8, h,
                                       base, half);
          if (x.mine && y.mine) {
            __stcs(out2 + g, make_ulonglong2(x.v, y.v));
          } else {
            if (x.mine) __stcs(a.out + 2 * g, x.v);
            if (y.mine) __stcs(a.out + 2 * g + 1, y.v);
          }
        }
      }
    }
  } else {
    for (Index f = s0 + threadIdx.x; f < s1; f += kStagedThreads * kUnroll) {
      int l[kUnroll];
      uint32_t ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Index s = f + u * kStagedThreads;
        if (s < s1) {
          l[u] = __ldcs(a.src_local + s);
          ok[u] = __ldcs(a.valid + s);
        }
      }
      if (!arrived) {
        mbar_wait(bar, 0);
        arrived = true;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Index s = f + u * kStagedThreads;
        if (s < s1) {
          const HalfSlot x =
              slot_half(a, s_x, s_act, l[u], ok[u], h, base, half);
          if (x.mine) __stcs(a.out + s, x.v);
        }
      }
    }
  }
  if (!arrived) mbar_wait(bar, 0);
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// The staged regime where piece_tiles is set (its 8-byte form for 8-byte
// words), else L2.
template <typename W, typename Index, bool VEC, bool LANES>
cudaError_t launch(const Args<W>& a, const long long* piece_tiles,
                   long long n_pieces, long long nm, int lanes, int dev,
                   cudaStream_t stream) {
  if (piece_tiles != nullptr) {
    auto kernel = [] {
      if constexpr (sizeof(W) == 4) return staged_kernel<Index, VEC, LANES>;
      else return halves_kernel<Index, VEC>;
    }();
    // per host thread and instantiation: the shared-memory limit is raised
    // once for each device it meets
    thread_local int raised_dev = -1;
    if (raised_dev != dev) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
      raised_dev = dev;
    }
    if constexpr (sizeof(W) == 4) {
      kernel<<<dim3((unsigned)n_pieces, lanes), kStagedThreads,
               staged_bytes(a.q), stream>>>(a, piece_tiles);
    } else {
      kernel<<<(unsigned)(2 * n_pieces * lanes), kStagedThreads,
               halves_bytes(a.q), stream>>>(a, piece_tiles, lanes);
    }
    return cudaGetLastError();
  }
  thread_local int sms_dev = -1, sms = 0;
  if (sms_dev != dev) {
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms_dev = dev;
  }
  const long long want = (nm + kL2Threads - 1) / kL2Threads;
  const long long most = (long long)sms * kL2BlocksPerSM;
  l2_kernel<W, Index, LANES>
      <<<dim3((unsigned)(want < most ? want : most), lanes), kL2Threads, 0,
         stream>>>(a, (Index)nm);
  return cudaGetLastError();
}

// Launches the bins of `lanes` inputs of W words: the staged regime where
// `pieces` is set, with four (8-byte words: two) slots a thread where `vec`;
// 32-bit slot indices where nm allows.
template <typename W>
cudaError_t launch_words(const Args<W>& a, const long long* pieces,
                         long long n_pieces, long long nm, int lanes,
                         bool vec, int dev, cudaStream_t s) {
  using I32 = uint32_t;
  using I64 = unsigned long long;
  auto go = [&](auto lane_form) {
    constexpr bool L = decltype(lane_form)::value;
    return nm <= 0x7fffffffLL
               ? (vec ? launch<W, I32, true, L>(a, pieces, n_pieces, nm,
                                                lanes, dev, s)
                      : launch<W, I32, false, L>(a, pieces, n_pieces, nm,
                                                 lanes, dev, s))
               : (vec ? launch<W, I64, true, L>(a, pieces, n_pieces, nm,
                                                lanes, dev, s)
                      : launch<W, I64, false, L>(a, pieces, n_pieces, nm,
                                                 lanes, dev, s));
  };
  return lanes > 1 ? go(std::true_type{}) : go(std::false_type{});
}

// Both C entries: `lanes` inputs x and active, x_stride entries apart,
// written to `lanes` bins out_stride apart; value_bytes (4 or 8) is the
// width of x's and out's words.
int run(const void* x, const void* active, const void* png_src_local,
        const void* png_valid, const void* png_tile_part,
        const void* piece_tiles, long long n_pieces, long long nm, int k,
        int q, int msg_tile, int lanes, long long x_stride,
        long long out_stride, unsigned long long ident_bits, int value_bytes,
        void* out, int device, int* regime, void* stream) {
  if (nm < 0 || k <= 0 || q <= 0 || msg_tile <= 0 || nm % msg_tile != 0 ||
      n_pieces < 0 || n_pieces > 0x7fffffffLL || device < 0 || lanes < 1 ||
      lanes > kMaxLanes || (value_bytes != 4 && value_bytes != 8) ||
      (lanes > 1 && (x_stride < (long long)k * q || out_stride < nm)))
    return (int)cudaErrorInvalidValue;
  // every lane's rows 16-byte aligned: the bases, and the lane strides of x
  // (4 B an entry) and active (1 B)
  const bool rows_aligned = aligned(x, 16) && aligned(active, 16) &&
                            (lanes == 1 || x_stride % 16 == 0);
  const bool staged =
      piece_tiles != nullptr && n_pieces > 0 && rows_aligned &&
      (value_bytes == 4
           ? q % 16 == 0 && q <= kMaxStagedQ
           : q % 32 == 0 && q <= kMaxHalvesQ &&
                 2 * n_pieces * lanes <= 0x7fffffffLL);
  *regime = staged ? kRegimeStaged : kRegimeL2;
  if (nm == 0) return 0;
  const long long* pieces =
      staged ? static_cast<const long long*>(piece_tiles) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* src_local = static_cast<const int*>(png_src_local);
  const uint8_t* valid = static_cast<const uint8_t*>(png_valid);
  const int* tile_part = static_cast<const int*>(png_tile_part);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  if (value_bytes == 8) {
    const Args<unsigned long long> a{
        static_cast<const unsigned long long*>(x), act, src_local, valid,
        tile_part, static_cast<unsigned long long*>(out), k, q, msg_tile,
        ident_bits, x_stride, out_stride};
    // two slots a thread where a pair never straddles a tile and the slot
    // arrays allow 8-byte (png_src_local), 2-byte (png_valid) and 16-byte
    // (every lane's out) access
    const bool vec = msg_tile % 2 == 0 && aligned(png_src_local, 8) &&
                     aligned(png_valid, 2) && aligned(out, 16) &&
                     (lanes == 1 || out_stride % 2 == 0);
    return (int)launch_words(a, pieces, n_pieces, nm, lanes, vec, device, s);
  }
  const Args<uint32_t> a{static_cast<const uint32_t*>(x), act, src_local,
                         valid, tile_part, static_cast<uint32_t*>(out),
                         k, q, msg_tile, (uint32_t)ident_bits, x_stride,
                         out_stride};
  // four slots a thread where they never straddle a tile and the slot
  // arrays allow 16-byte (png_src_local, every lane's out) and 4-byte
  // (png_valid) access
  const bool vec = msg_tile % 4 == 0 && aligned(png_src_local, 16) &&
                   aligned(png_valid, 4) && aligned(out, 16) &&
                   (lanes == 1 || out_stride % 4 == 0);
  return (int)launch_words(a, pieces, n_pieces, nm, lanes, vec, device, s);
}

}  // namespace

// Returns 0 or a cudaError_t, and sets *regime to the regime it launched
// (0: L2, 1: staged).  Pointers are device pointers on the current device,
// whose index is `device`; x holds k*q values of value_bytes (4 or 8) bytes,
// out nm, active k*q bytes; ident_bits is the identity's bit pattern (its
// low 32 bits for 4-byte values).  piece_tiles is null (the L2 regime) or
// holds n_pieces + 1 ascending tile offsets from 0 to nm / msg_tile
// (dc_pieces); it is used where the shape allows the staged regime: x and
// active 16-byte aligned, and q % 16 == 0 and q <= 46,480 for 4-byte values,
// q % 32 == 0 and q <= 51,648 for 8-byte ones.
extern "C" int dc_gather(const void* x, const void* active,
                         const void* png_src_local, const void* png_valid,
                         const void* png_tile_part, const void* piece_tiles,
                         long long n_pieces, long long nm, int k, int q,
                         int msg_tile, unsigned long long ident_bits,
                         int value_bytes, void* out, int device, int* regime,
                         void* stream) {
  return run(x, active, png_src_local, png_valid, png_tile_part, piece_tiles,
             n_pieces, nm, k, q, msg_tile, 1, 0, 0, ident_bits, value_bytes,
             out, device, regime, stream);
}

// The lane form: one launch writes the bins of `lanes` inputs, lane b on
// blockIdx.y == b.  Lane b's x and active start x_stride * b entries in
// (>= k*q), its out out_stride * b (>= nm); 1 <= lanes <= 65,535.  A lane
// stages its own rows: the staged regime also needs x_stride % 16 == 0, so
// that every lane's rows are 16-byte aligned (and, for 8-byte values, 2 *
// n_pieces * lanes blocks, at most 2**31 - 1).  The rest as dc_gather.
extern "C" int dc_gather_lanes(const void* x, const void* active,
                               const void* png_src_local,
                               const void* png_valid,
                               const void* png_tile_part,
                               const void* piece_tiles, long long n_pieces,
                               long long nm, int k, int q, int msg_tile,
                               int lanes, long long x_stride,
                               long long out_stride,
                               unsigned long long ident_bits, int value_bytes,
                               void* out, int device, int* regime,
                               void* stream) {
  return run(x, active, png_src_local, png_valid, png_tile_part, piece_tiles,
             n_pieces, nm, k, q, msg_tile, lanes, x_stride, out_stride,
             ident_bits, value_bytes, out, device, regime, stream);
}

extern "C" const char* dc_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
