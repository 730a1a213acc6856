// lane_partials: the lane-RMQ candidates other than the interior, for a batch
// of queries over 128-wide lane blocks (the first pass of ops.lane_query).
//
// Replaces the Pallas TPU kernel ``lane_partials`` of
// src/repro/kernels/lane_query.py (body ``_kernel``). Per query, from the
// caller's (sl, sr, llo, rlo):
//   sl == sr: the masked leftmost min of xs[sl, llo..rlo], at global index
//             sl * 128 + lane (row_min, as in fused_query.cu);
//   sl != sr: the suffix minimum at (sl, llo) against the prefix minimum at
//             (sr, rlo), the suffix winning on equal values (its indices are
//             the smaller).
// Returns (value, global index).
//
// Bound: per query either one 128-element row (same block) or four cells
// (straddling), 16 bytes of bounds and one (value, index) written: under
// 2.3 MB at B = 4096, float32, 0.7 us at 3.35 TB/s; scattered dependent
// loads make it latency-bound.
//
// Design: one warp per query, ``tile`` warps per thread block. A same-block
// query scans its row with the whole warp; a straddling one needs only lane
// 0's four cell loads. Queries past B are masked; lane-block ids are clamped
// to [0, nsub) so a malformed bound never reads outside the planes.

#include "common.cuh"

namespace repro {

constexpr int kLane = 128;  // core/lane_rmq.LANE

template <typename T>
__global__ void lane_partials_kernel(const T* __restrict__ xs, const T* __restrict__ suff_val,
                                     const int32_t* __restrict__ suff_idx,
                                     const T* __restrict__ pref_val,
                                     const int32_t* __restrict__ pref_idx,
                                     const int32_t* __restrict__ SL,
                                     const int32_t* __restrict__ SR,
                                     const int32_t* __restrict__ LLO,
                                     const int32_t* __restrict__ RLO, T* __restrict__ out_val,
                                     int32_t* __restrict__ out_idx, int B, int nsub) {
  const int lane = threadIdx.x & 31;
  const long long q = warp_query();
  if (q >= B) return;  // whole warp leaves together
  const int sl = min(max(SL[q], 0), nsub - 1);
  const int sr = min(max(SR[q], 0), nsub - 1);
  const int llo = min(max(LLO[q], 0), kLane - 1);
  const int rlo = min(max(RLO[q], 0), kLane - 1);

  if (sl == sr) {
    T v;
    int pos;
    row_min(xs + (long long)sl * kLane, llo, rlo, kLane, lane, v, pos);
    if (lane == 0) {
      out_val[q] = v;
      out_idx[q] = sl * kLane + pos;
    }
    return;
  }
  if (lane != 0) return;
  const long long a = (long long)sl * kLane + llo;
  const long long b = (long long)sr * kLane + rlo;
  const T lv = suff_val[a];
  const T rv = pref_val[b];
  const bool take_l = lv <= rv;
  out_val[q] = take_l ? lv : rv;
  out_idx[q] = take_l ? suff_idx[a] : pref_idx[b];
}

template <typename T>
static int launch_lane_partials(const void* xs, const void* suff_val, const void* suff_idx,
                                const void* pref_val, const void* pref_idx, const void* sl,
                                const void* sr, const void* llo, const void* rlo, void* out_val,
                                void* out_idx, int B, int nsub, int tile, void* stream) {
  const dim3 block(32 * tile);
  const dim3 grid((B + tile - 1) / tile);
  lane_partials_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)xs, (const T*)suff_val, (const int32_t*)suff_idx, (const T*)pref_val,
      (const int32_t*)pref_idx, (const int32_t*)sl, (const int32_t*)sr, (const int32_t*)llo,
      (const int32_t*)rlo, (T*)out_val, (int32_t*)out_idx, B, nsub);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_lane_partials_f32(const void* xs, const void* suff_val, const void* suff_idx,
                                       const void* pref_val, const void* pref_idx, const void* sl,
                                       const void* sr, const void* llo, const void* rlo,
                                       void* out_val, void* out_idx, int B, int nsub, int tile,
                                       void* stream) {
  return repro::launch_lane_partials<float>(xs, suff_val, suff_idx, pref_val, pref_idx, sl, sr,
                                            llo, rlo, out_val, out_idx, B, nsub, tile, stream);
}

extern "C" int repro_lane_partials_i32(const void* xs, const void* suff_val, const void* suff_idx,
                                       const void* pref_val, const void* pref_idx, const void* sl,
                                       const void* sr, const void* llo, const void* rlo,
                                       void* out_val, void* out_idx, int B, int nsub, int tile,
                                       void* stream) {
  return repro::launch_lane_partials<int32_t>(xs, suff_val, suff_idx, pref_val, pref_idx, sl, sr,
                                              llo, rlo, out_val, out_idx, B, nsub, tile, stream);
}
