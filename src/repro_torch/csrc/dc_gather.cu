// The DC scatter on Hopper: write each PNG message slot's value into the bins.
//
// Replaces the Pallas kernel repro.kernels.dc_gather.dc_gather
// (src/repro/kernels/dc_gather.py:62).  Python side:
// repro_torch/kernels/dc_gather.py (dc_gather_cuda).
//
// Slot s of the [NM] bins gets x[p * q + png_src_local[s]], with
// p = png_tile_part[s / msg_tile] the source partition of its slot tile, when
// png_valid[s] and that source is active, and the monoid identity otherwise.
//
// What bounds it on this card: bytes.  Each slot reads png_src_local (4 B)
// and png_valid (1 B) and writes its value (4 B); png_tile_part is one word
// per msg_tile slots.  The [k, q] value and activity tables (about 17 MB +
// 4 MB at RMAT scale 22) are read at random but fit the 50 MB L2.
//
// Design: the output is a pure select of 4-byte words, so the kernel moves
// bits (uint32) and takes the identity's bit pattern from the wrapper; one
// kernel serves every monoid and dtype.  One thread per slot in a grid-stride
// loop: neighbouring threads read and write neighbouring slots, so the three
// streams coalesce.  The TPU kernel's per-tile BlockSpec that brings the
// source partition's row into VMEM is not carried over: each slot computes
// its global source id itself and the row is read through L2.  A source id
// outside [0, k*q) (a malformed layout) writes the identity.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads) dc_gather_kernel(
    const uint32_t* __restrict__ x, const uint8_t* __restrict__ active,
    const int* __restrict__ png_src_local,
    const uint8_t* __restrict__ png_valid,
    const int* __restrict__ png_tile_part, long long nm, int k, int q,
    int msg_tile, uint32_t ident, uint32_t* __restrict__ out) {
  for (long long s = (long long)blockIdx.x * kThreads + threadIdx.x; s < nm;
       s += (long long)gridDim.x * kThreads) {
    const uint8_t ok = png_valid[s];
    const int local = png_src_local[s];
    const int part = png_tile_part[s / msg_tile];
    uint32_t v = ident;
    if (ok && local >= 0 && local < q && part >= 0 && part < k) {
      const long long src = (long long)part * q + local;
      if (active[src]) v = x[src];
    }
    out[s] = v;
  }
}

}  // namespace

// Returns 0 or the cudaError_t of the launch.  Pointers are device pointers;
// x holds k*q four-byte values, active k*q bytes.
extern "C" int dc_gather(const void* x, const void* active,
                         const void* png_src_local, const void* png_valid,
                         const void* png_tile_part, long long nm, int k, int q,
                         int msg_tile, unsigned ident_bits, void* out,
                         void* stream) {
  if (nm < 0 || k <= 0 || q <= 0 || msg_tile <= 0 || nm % msg_tile != 0)
    return (int)cudaErrorInvalidValue;
  if (nm == 0) return 0;
  const long long b = (nm + kThreads - 1) / kThreads;
  const int blocks = (int)(b > kMaxBlocks ? kMaxBlocks : b);
  dc_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint8_t*>(active),
      static_cast<const int*>(png_src_local),
      static_cast<const uint8_t*>(png_valid),
      static_cast<const int*>(png_tile_part), nm, k, q, msg_tile, ident_bits,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* dc_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
