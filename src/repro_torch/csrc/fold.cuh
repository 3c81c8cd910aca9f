// Monoid folds and edge functions shared by the fold kernels (fused_dc.cu,
// fused_stream.cu, segment_combine.cu, segment_fold.cu, spmv_block.cu).
//
// A fold is one of {add, min, max} over one of {float, int, unsigned}, the
// combinations the Pallas kernels of the reference lower, or min over long
// long: the packed (f32 key bits << 32) | payload words of the reference's
// 8-byte min_with_payload, carried as int64 (every word of a key with its
// sign bit clear lies below 2**63, so signed order is the reference's
// uint64 order; identity LLONG_MAX; repro_torch/core/monoid.py).  Each fold
// into memory is one atomic (a native 64-bit atomicMin for long long), so
// the same code serves shared and global memory; combine() folds two values
// in registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

enum { MONOID_ADD = 0, MONOID_MIN = 1, MONOID_MAX = 2 };
enum { DTYPE_F32 = 0, DTYPE_I32 = 1, DTYPE_U32 = 2, DTYPE_I64 = 3 };

template <int M, typename T>
struct Combo {
  static constexpr int monoid = M;
  using type = T;
};

template <int M, typename T>
__device__ __forceinline__ T identity() {
  if constexpr (M == MONOID_ADD) {
    return T(0);
  } else if constexpr (std::is_same_v<T, float>) {
    return M == MONOID_MIN ? __uint_as_float(0x7f800000u)    // +inf
                           : __uint_as_float(0xff800000u);   // -inf
  } else if constexpr (std::is_same_v<T, int>) {
    return M == MONOID_MIN ? INT_MAX : INT_MIN;
  } else if constexpr (std::is_same_v<T, long long>) {
    return M == MONOID_MIN ? LLONG_MAX : LLONG_MIN;
  } else {
    return M == MONOID_MIN ? 0xffffffffu : 0u;
  }
}

// Fold v into *addr.  CUDA has no float atomicMin/atomicMax, so floats are
// ordered through their bits: a float with the sign bit clear orders like its
// bits read as a signed int, and one with the sign bit set orders in reverse
// of its bits read as unsigned.  Every finite value, and +-inf, folds exactly
// as min/max would; -0.0 folds as less than +0.0.  NaN payloads are outside
// the contract (a positive NaN never wins a min, a negative one always does).
template <int M, typename T>
__device__ __forceinline__ void fold_into(T* addr, T v) {
  if constexpr (M == MONOID_ADD) {
    atomicAdd(addr, v);
  } else if constexpr (std::is_same_v<T, float>) {
    const int bits = __float_as_int(v);
    if constexpr (M == MONOID_MIN) {
      if (bits >= 0) atomicMin(reinterpret_cast<int*>(addr), bits);
      else atomicMax(reinterpret_cast<unsigned*>(addr), static_cast<unsigned>(bits));
    } else {
      if (bits >= 0) atomicMax(reinterpret_cast<int*>(addr), bits);
      else atomicMin(reinterpret_cast<unsigned*>(addr), static_cast<unsigned>(bits));
    }
  } else if constexpr (M == MONOID_MIN) {
    atomicMin(addr, v);
  } else {
    atomicMax(addr, v);
  }
}

// The monoid's combine in registers, ordering floats as fold_into does
// (through their bits, so -0.0 is less than +0.0).
template <int M, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (M == MONOID_ADD) {
    return a + b;
  } else if constexpr (std::is_same_v<T, float>) {
    const int ba = __float_as_int(a), bb = __float_as_int(b);
    const int ka = ba >= 0 ? ba : ba ^ 0x7fffffff;
    const int kb = bb >= 0 ? bb : bb ^ 0x7fffffff;
    return (M == MONOID_MIN ? ka <= kb : ka >= kb) ? a : b;
  } else if constexpr (M == MONOID_MIN) {
    return a < b ? a : b;
  } else {
    return a > b ? a : b;
  }
}

// The edge functions of the fused DC kernels (fused_dc.cu, fused_stream.cu),
// applied to the value an edge gathers from the table: none; EDGE_ADD_WEIGHT
// (float tables: plus the edge's weight); EDGE_ADD_WEIGHT_TO_KEY (the packed
// long long words of min_with_payload: the weight added to the f32 key).
enum { EDGE_NONE = 0, EDGE_ADD_WEIGHT = 1, EDGE_ADD_WEIGHT_TO_KEY = 2 };

// The packed word v with w added to its f32 key (the high word), rounded
// once to nearest (__fadd_rn, never contracted), over the same payload.
__device__ __forceinline__ long long add_weight_to_key(long long v, float w) {
  const unsigned long long u = static_cast<unsigned long long>(v);
  const float key = __uint_as_float(static_cast<unsigned>(u >> 32));
  const unsigned long long hi = __float_as_uint(__fadd_rn(key, w));
  return static_cast<long long>(hi << 32 | (u & 0xffffffffull));
}

template <int EF, typename T>
__device__ __forceinline__ T apply_edge(T v, float w) {
  if constexpr (EF == EDGE_ADD_WEIGHT) return v + w;
  else if constexpr (EF == EDGE_ADD_WEIGHT_TO_KEY) return add_weight_to_key(v, w);
  else return v;
}

// Calls fn(std::integral_constant<int, EF>{}) for the runtime edge function
// over tables of T: none for every T, EDGE_ADD_WEIGHT for float and
// EDGE_ADD_WEIGHT_TO_KEY for long long.
template <typename T, typename Fn>
cudaError_t dispatch_edge(int edge_fn, Fn fn) {
  if (edge_fn == EDGE_NONE) return fn(std::integral_constant<int, EDGE_NONE>{});
  if constexpr (std::is_same_v<T, float>) {
    if (edge_fn == EDGE_ADD_WEIGHT)
      return fn(std::integral_constant<int, EDGE_ADD_WEIGHT>{});
  }
  if constexpr (std::is_same_v<T, long long>) {
    if (edge_fn == EDGE_ADD_WEIGHT_TO_KEY)
      return fn(std::integral_constant<int, EDGE_ADD_WEIGHT_TO_KEY>{});
  }
  return cudaErrorInvalidValue;
}

// Calls fn(Combo<M, T>{}) for the runtime (monoid, dtype) pair; long long
// with min only.
template <typename Fn>
cudaError_t dispatch_combo(int monoid, int dtype, Fn fn) {
#define REPRO_DTYPES(M)                                    \
  switch (dtype) {                                         \
    case DTYPE_F32: return fn(Combo<M, float>{});          \
    case DTYPE_I32: return fn(Combo<M, int>{});            \
    case DTYPE_U32: return fn(Combo<M, unsigned>{});       \
    default: return cudaErrorInvalidValue;                 \
  }
  switch (monoid) {
    case MONOID_ADD: REPRO_DTYPES(MONOID_ADD)
    case MONOID_MIN:
      if (dtype == DTYPE_I64) return fn(Combo<MONOID_MIN, long long>{});
      REPRO_DTYPES(MONOID_MIN)
    case MONOID_MAX: REPRO_DTYPES(MONOID_MAX)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DTYPES
}
