// block_min: per-block minimum and its leftmost lane (the build's level 1).
//
// Replaces the Pallas TPU kernel ``block_min`` of
// src/repro/kernels/block_min.py (body ``_kernel``), which reduced one
// (8, bs) VMEM tile per grid step with a vector min and a min over the
// masked iota.
//
// Bound: one read of the (nb, bs) blocks and one write of nb values and nb
// int32 lanes. At n = 2^26 float32 that is 268 MB read plus 4 MB written,
// about 81 us at the H100's data-sheet 3.35 TB/s; the work is a handful of
// compares per element, far below the compute roofline, so bytes bound it.
//
// Design: one warp per row, ``rows_per_block`` rows per thread block. Lane
// ``t`` reads elements t, t+32, t+64, ... of its row, so each step of the
// warp is one coalesced 128-byte read. A lane keeps its strictly smaller
// value (earlier positions win ties within the lane), then a shuffle
// reduction over (value, position) keeps the lower position on equal
// values. The value written is the one the leftmost minimum holds. The grid
// covers nb rows and the last block masks rows past nb, so rows need no
// padding to a tile multiple.

#include "common.cuh"

namespace repro {

template <typename T>
__global__ void block_min_kernel(const T* __restrict__ x, T* __restrict__ val,
                                 int32_t* __restrict__ idx, int nb, int bs) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= nb) return;  // whole warp leaves together
  const T* p = x + row * (long long)bs;
  T best = p[lane];  // bs is a multiple of 128, so every lane has a first element
  int pos = lane;
  for (int j = lane + 32; j < bs; j += 32) {
    const T v = p[j];
    if (v < best) {
      best = v;
      pos = j;
    }
  }
  warp_leftmost_min(best, pos);
  if (lane == 0) {
    val[row] = best;
    idx[row] = pos;
  }
}

template <typename T>
static int launch_block_min(const void* x, void* val, void* idx, int nb, int bs,
                            int rows_per_block, void* stream) {
  const dim3 block(32 * rows_per_block);
  const dim3 grid((nb + rows_per_block - 1) / rows_per_block);
  block_min_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)val, (int32_t*)idx, nb, bs);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_block_min_f32(const void* x, void* val, void* idx, int nb, int bs,
                                   int rows_per_block, void* stream) {
  return repro::launch_block_min<float>(x, val, idx, nb, bs, rows_per_block, stream);
}

extern "C" int repro_block_min_i32(const void* x, void* val, void* idx, int nb, int bs,
                                   int rows_per_block, void* stream) {
  return repro::launch_block_min<int32_t>(x, val, idx, nb, bs, rows_per_block, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
