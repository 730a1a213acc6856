// lane_partials: the lane-RMQ candidates other than the interior, for a batch
// of queries over 128-wide lane blocks (the first pass of ops.lane_query).
//
// Replaces the Pallas TPU kernel ``lane_partials`` of
// src/repro/kernels/lane_query.py (body ``_kernel``). Per query, from the
// caller's (sl, sr, llo, rlo):
//   sl == sr: the masked leftmost min of xs[sl, llo..rlo], at global index
//             sl * 128 + lane;
//   sl != sr: the suffix minimum at (sl, llo) against the prefix minimum at
//             (sr, rlo), the suffix winning on equal values (its indices are
//             the smaller).
// Returns (value, global index).
//
// Bound: per query the bytes it must move: a same-block query's in-range
// elements, a straddling one's two cells (value and index each), 16 bytes of
// bounds and one (value, index) written (``chip_smoke._lane_bytes``). At
// B = 4096 with lengths uniform in [1, 8192] (almost all straddling) that is
// about 170 KB, 0.05 us at 3.35 TB/s. What bounds the kernel is the floor of
// one query: the launch and two dependent round trips to device memory (the
// bounds, then the cells or rows), about 1.3 us warm for one query
// (PERF.md).
//
// What held the first version back: one warp per query (4096 warps for a
// batch of 4096), whose lane 0 alone read the cells of a straddling query,
// the index only after the value compare had chosen its plane (3 round
// trips); a same-block query scanned its row in 4-byte steps and read it
// again when its minimum was a zero.
//
// Design: a warp owns kQueries = 4 queries, one per lane 0..3, and ``tile``
// warps make a thread block.
//   Round trip 1: lanes 0..3 load their queries' bounds (coalesced);
//     lane-block ids are clamped to [0, nsub) so a malformed bound never
//     reads outside the planes.
//   Round trip 2: each straddling lane issues its four cell loads at once
//     (suff_val[a], suff_idx[a], pref_val[b], pref_idx[b]) and picks
//     lv <= rv. With them, when a ballot finds same-block queries, the whole
//     warp issues one 16-byte piece per lane of each of their rows (a lane
//     whose four values miss the range loads nothing); each lane folds its
//     pieces (``LaneMin``), one reduce-scatter over the warp reduces all the
//     rows at once (``rows_min``), and one OR of the lanes' flags gives each
//     row the sign of a zero minimum, so no row is read twice.
// Why 4 queries: a warp that owned 32 queries had to take their same-block
// rows a few at a time (registers allow about 8 rows in flight), each pass
// a round trip plus a serial reduction in one warp, and at the default tile
// a batch of 4096 ran on 16 SMs: it lost to the first version on the card.
// Of 1, 2, 4 and 8 queries per warp (``tools/kernel_ab.py --lane-queries``),
// 4 is the fastest or within 4% of it on every batch at tiles 1, 4 and 8,
// warm and cold; 1 and 2 lose 21-90% warm at tile 1, and 8 (63 and 64
// registers) loses 7-19% at tile 8 (PERF.md). With 4 every row of a warp is in flight at once and
// a batch of 4096 fills 128 blocks at tile 8.
// Lanes past B, and lanes 4..31, stay in the warp until its last shuffle
// and ballot.

#include "common.cuh"

namespace repro {

// Queries per warp, one per lane 0..kQueries-1. tools/kernel_ab.py
// --lane-queries builds the kernel with another count, to time the choice.
#ifndef REPRO_LANE_QUERIES
#define REPRO_LANE_QUERIES 4
#endif

constexpr int kLane = 128;  // core/lane_rmq.LANE
constexpr int kQueries = REPRO_LANE_QUERIES;
static_assert(kQueries >= 1 && kQueries <= 32 && (kQueries & (kQueries - 1)) == 0,
              "queries per warp: a power of two up to 32");
constexpr int kPer = 32 / kQueries;  // lanes that hold one row after the reduce-scatter

__device__ __forceinline__ int32_t zero_sign_of(int32_t v, bool) { return v; }
__device__ __forceinline__ float zero_sign_of(float v, bool neg) {
  return v == 0.0f ? (neg ? -0.0f : 0.0f) : v;
}

// The leftmost minima of the warp's kQueries rows, from one 16-byte piece per
// lane of each (``w``, positions 4 * lane.., range [lo, hi]; an empty range
// for a row no query asked for). Each lane folds its pieces; each round of
// the reduce-scatter halves the rows a lane holds and doubles the lanes that
// hold one, so lanes kPer * j.. end with row j, and lane j fetches it. A
// position outside a row's range never wins a tie (``LaneMin::fold``), so a
// row whose range holds only maxval answers with its first in-range
// position. The sign of a zero minimum is the OR of the lanes' flags. Valid in lanes
// 0..kQueries-1: (value, position in the row).
template <typename T>
__device__ __forceinline__ void rows_min(const int4 (&w)[kQueries], const int (&lo)[kQueries],
                                         const int (&hi)[kQueries], int lane, T& v, int& pos) {
  T rv[kQueries];
  int rp[kQueries];
  unsigned neg = 0;
#pragma unroll
  for (int j = 0; j < kQueries; ++j) {
    LaneMin<T> c(lo[j]);
    c.fold(w[j], 4 * lane, lo[j], hi[j]);
    rv[j] = c.v;
    rp[j] = c.pos;
    neg |= (unsigned)c.neg << j;
  }
#pragma unroll
  for (int half = kQueries / 2, off = 16; half >= 1; half >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      T kv = upper ? rv[i + half] : rv[i];
      int kp = upper ? rp[i + half] : rp[i];
      const T ov = __shfl_xor_sync(kFullMask, upper ? rv[i] : rv[i + half], off);
      const int op = __shfl_xor_sync(kFullMask, upper ? rp[i] : rp[i + half], off);
      take_leftmost(ov, op, kv, kp);
      rv[i] = kv;
      rp[i] = kp;
    }
  }
#pragma unroll
  for (int off = kPer / 2; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(kFullMask, rv[0], off);
    const int op = __shfl_xor_sync(kFullMask, rp[0], off);
    take_leftmost(ov, op, rv[0], rp[0]);
  }
  const int from = (lane % kQueries) * kPer;
  v = __shfl_sync(kFullMask, rv[0], from);
  pos = __shfl_sync(kFullMask, rp[0], from);
  v = zero_sign_of(v, (__reduce_or_sync(kFullMask, neg) >> lane) & 1);
}

template <typename T>
__global__ void __launch_bounds__(1024)
    lane_partials_kernel(const T* __restrict__ xs, const T* __restrict__ suff_val,
                         const int32_t* __restrict__ suff_idx, const T* __restrict__ pref_val,
                         const int32_t* __restrict__ pref_idx, const int32_t* __restrict__ SL,
                         const int32_t* __restrict__ SR, const int32_t* __restrict__ LLO,
                         const int32_t* __restrict__ RLO, T* __restrict__ out_val,
                         int32_t* __restrict__ out_idx, int B, int nsub) {
  const int lane = threadIdx.x & 31;
  const long long q = warp_query() * kQueries + lane;
  const bool live = lane < kQueries && q < B;

  // Round trip 1: the bounds.
  int sl = 0, sr = 0, llo = 0, rlo = 0;
  if (live) {
    sl = min(max(SL[q], 0), nsub - 1);
    sr = min(max(SR[q], 0), nsub - 1);
    llo = min(max(LLO[q], 0), kLane - 1);
    rlo = min(max(RLO[q], 0), kLane - 1);
  }
  const bool straddle = live && sl != sr;
  const bool same = live && sl == sr;
  const unsigned rows = __ballot_sync(kFullMask, same);  // the same in every lane

  // Round trip 2: a straddling lane's four cells, ...
  T lv = T(), rv = T();
  int32_t li = 0, ri = 0;
  if (straddle) {
    const long long a = (long long)sl * kLane + llo;
    const long long b = (long long)sr * kLane + rlo;
    lv = suff_val[a];
    li = suff_idx[a];
    rv = pref_val[b];
    ri = pref_idx[b];
  }
  // ... and the same-block rows, lane j's row in slot j (an empty range when
  // lane j has none).
  int4 w[kQueries];
  int lo[kQueries], hi[kQueries];
  if (rows) {
    const int own_lo = same ? llo : kLane;
    const int own_hi = same ? rlo : -1;
#pragma unroll
    for (int j = 0; j < kQueries; ++j) {
      const int row = __shfl_sync(kFullMask, sl, j);
      lo[j] = __shfl_sync(kFullMask, own_lo, j);
      hi[j] = __shfl_sync(kFullMask, own_hi, j);
      w[j] = load_piece(xs + (long long)row * kLane, 4 * lane, lo[j], hi[j]);
    }
  }

  T ov = T();
  int32_t oi = 0;
  if (straddle) {
    const bool take_l = lv <= rv;
    ov = take_l ? lv : rv;
    oi = take_l ? li : ri;
  }
  if (rows) {
    T v;
    int pos;
    rows_min(w, lo, hi, lane, v, pos);
    if (same) {
      ov = v;
      oi = sl * kLane + pos;
    }
  }
  if (live) {
    out_val[q] = ov;
    out_idx[q] = oi;
  }
}

template <typename T>
static int launch_lane_partials(const void* xs, const void* suff_val, const void* suff_idx,
                                const void* pref_val, const void* pref_idx, const void* sl,
                                const void* sr, const void* llo, const void* rlo, void* out_val,
                                void* out_idx, int B, int nsub, int tile, void* stream) {
  const int warps = (B + kQueries - 1) / kQueries;
  const dim3 block(32 * tile);
  const dim3 grid((warps + tile - 1) / tile);
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
