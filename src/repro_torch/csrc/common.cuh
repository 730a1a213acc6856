// Shared device helpers of the RMQ kernels: the padding value of each value
// type and the leftmost warp reduction.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// The value a masked-out lane carries: +inf for float, INT32_MAX for int32
// (``core/block_rmq.maxval``).
template <typename T>
struct MaxVal;
template <>
struct MaxVal<float> {
  __device__ __forceinline__ static float get() { return __int_as_float(0x7f800000); }
};
template <>
struct MaxVal<int32_t> {
  __device__ __forceinline__ static int32_t get() { return 0x7fffffff; }
};

// Warp-wide min over (value, position) pairs: the smaller value wins, and on
// equal values (``==``, so -0.0 ties +0.0) the lower position wins. Every
// lane of the warp ends with the result. This is the masked-iota rule
// ``min(where(x == vmin, iota, bs))`` of the reference kernels, in one pass.
template <typename T>
__device__ __forceinline__ void warp_leftmost_min(T& v, int& pos) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int op = __shfl_xor_sync(0xffffffffu, pos, off);
    if (ov < v || (ov == v && op < pos)) {
      v = ov;
      pos = op;
    }
  }
}

}  // namespace repro
