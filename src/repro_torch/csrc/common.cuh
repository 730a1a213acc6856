// Shared device code of the RMQ kernels: the padding value of each value
// type, the leftmost warp reductions, the sign of a zero minimum, the
// per-query decomposition, the 16-byte row pieces and their per-lane fold,
// the partial stage of a blocked query and the fused blocked-query kernel.
//
// The fused body replaces the per-query work of the Pallas TPU megakernels
// ``fused_query`` (body ``_kernel``) and ``fused_query_packed`` quantized
// (body ``_kernel_quantized``) of src/repro/kernels/fused_query.py;
// fused_query.cu instantiates it with the resident and dma interiors,
// fused_query_packed.cu with the quantized one, and rmq_partials.cu runs its
// partial stage alone.
//
// Bound: per query a few hundred bytes (its one or two partial ranges, two
// interior cells, the bounds, one result): at B = 4096, bs = 128, float32,
// about 4.8 MB, 1.4 us at 3.35 TB/s. A batch is far too small to keep the
// card's memory busy, so what bounds it is the chain of dependent
// device-memory round trips each query waits through, several hundred ns
// each when L2 is cold.
//
// What held the first body back: a chain of 4 to 6 dependent round trips per
// query. The bounds; the left row in 4-byte steps; only then the right row;
// then lane 0 alone read the interior cells, and the resident and quantized
// interiors waited once more for their hop. A zero minimum read its row again.
//
// What this body does: after the bounds, every load that depends on nothing
// else is in flight at once. Lanes 0 and 1 issue the two first-level interior
// cells; every lane issues one 16-byte load per 128-value piece of both
// partial rows (a lane whose four values miss the range loads nothing); the
// resident or quantized hop is issued next, while the rows arrive; then both
// rows reduce in the same five shuffle rounds, and the sign of a zero minimum
// comes from the values the lanes already hold. Written for 2 dependent
// round trips per query for dma (the bounds; the rows and cells together)
// and 3 for resident and quantized (the hop). The SASS of the dma body
// shows 3: the compiler sinks the cell loads, which sit behind a branch,
// past the rows' fold, and the hop waits behind them. An unconditional load
// from the clamped cell, as fused_query_packed.cu's packed32 body does, is
// queued (PERF.md §7).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

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

// A value's 32-bit word and back.
__device__ __forceinline__ int32_t to_word(float v) { return __float_as_int(v); }
__device__ __forceinline__ int32_t to_word(int32_t v) { return v; }
template <typename T>
__device__ __forceinline__ T from_word(int32_t w);
template <>
__device__ __forceinline__ float from_word<float>(int32_t w) {
  return __int_as_float(w);
}
template <>
__device__ __forceinline__ int32_t from_word<int32_t>(int32_t w) {
  return w;
}

__device__ __forceinline__ bool is_neg_zero(float v) { return __float_as_int(v) == (int)0x80000000; }
__device__ __forceinline__ bool is_neg_zero(int32_t) { return false; }

// ``jnp.minimum(a, b)``: -0.0 below +0.0. Equal nonzero values share one word,
// so on equal values the OR of the two words keeps a -0.0.
template <typename T>
__device__ __forceinline__ T signed_min(T a, T b) {
  if (a == b) return from_word<T>(to_word(a) | to_word(b));
  return a < b ? a : b;
}

// The rule of every (value, position) reduction: the smaller value wins, and
// on equal values (``==``, so -0.0 ties +0.0) the lower position. This is the
// masked-iota rule ``min(where(x == vmin, iota, bs))`` of the reference
// kernels, in one pass.
template <typename T>
__device__ __forceinline__ void take_leftmost(T ov, int op, T& v, int& pos) {
  if (ov < v || (ov == v && op < pos)) {
    v = ov;
    pos = op;
  }
}

// Warp-wide leftmost min over (value, position) pairs; every lane of the warp
// ends with the result.
template <typename T>
__device__ __forceinline__ void warp_leftmost_min(T& v, int& pos) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(kFullMask, v, off);
    const int op = __shfl_xor_sync(kFullMask, pos, off);
    take_leftmost(ov, op, v, pos);
  }
}

// Two warp-wide leftmost mins in the same five shuffle rounds: the two
// reductions are independent, so their shuffles overlap.
template <typename T>
__device__ __forceinline__ void warp_leftmost_min2(T& a, int& ap, T& b, int& bp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T oa = __shfl_xor_sync(kFullMask, a, off);
    const int oap = __shfl_xor_sync(kFullMask, ap, off);
    const T ob = __shfl_xor_sync(kFullMask, b, off);
    const int obp = __shfl_xor_sync(kFullMask, bp, off);
    take_leftmost(oa, oap, a, ap);
    take_leftmost(ob, obp, b, bp);
  }
}

// The sign of a zero minimum. The reference kernels' ``vmin = jnp.min(row)``
// is -0.0 when the minimum is zero and a -0.0 takes part, whichever zero
// comes first; the pair reductions keep the leftmost zero's bits.
//
// ``zero_sign`` (block_min.cu): when (and only when) the warp's minimum
// ``v`` is a zero, its lanes scan row[lo..hi] again for a -0.0 and vote. ``signed_zero``: the same vote over
// a flag each lane set while it folded its values, with no second read.
// ``v`` is the same in every lane, so the warp branches together. Integers
// have one zero.
__device__ __forceinline__ int32_t zero_sign(const int32_t*, int, int, int, int, int32_t v) {
  return v;
}
__device__ __forceinline__ float zero_sign(const float* __restrict__ row, int lo, int hi, int bs,
                                           int lane, float v) {
  if (v != 0.0f) return v;
  bool neg = false;
  for (int p = lane; p < bs; p += 32) {
    if (p >= lo && p <= hi) neg |= is_neg_zero(row[p]);
  }
  return __any_sync(kFullMask, neg) ? -0.0f : 0.0f;
}
__device__ __forceinline__ int32_t signed_zero(int32_t v, bool) { return v; }
__device__ __forceinline__ float signed_zero(float v, bool neg) {
  if (v != 0.0f) return v;
  return __any_sync(kFullMask, neg) ? -0.0f : 0.0f;
}

// The warp's query id: ``tile`` warps (queries) per thread block.
__device__ __forceinline__ long long warp_query() {
  return (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
}

// The per-query scalars of a blocked query (the host side of the reference's
// fused_query.py:224-237 and :519-531), per warp: the end blocks bl and br,
// the left partial ls..le in bl, the right partial 0..re in br, and the
// doubling-table cells (k, ilo) and (k, bpos) of the interior [ilo, ihi],
// with k = floor(log2(ihi - ilo + 1)) taken exactly as 31 - clz. Block ids
// are clamped to [0, nb) so a malformed bound never reads outside the
// tensors; valid bounds are never changed by the clamp.
struct Decomp {
  int bl, br, ls, le, re, ilo, bpos, k;
  bool hasint;
};

__device__ __forceinline__ Decomp decompose(int l, int r, int nb, int bs) {
  Decomp d;
  d.bl = min(max(l / bs, 0), nb - 1);
  d.br = min(max(r / bs, 0), nb - 1);
  d.ls = l - d.bl * bs;
  d.re = r - d.br * bs;
  d.le = (d.bl == d.br) ? d.re : bs - 1;
  d.hasint = (d.br - d.bl) >= 2;
  d.ilo = min(max(d.bl + 1, 0), nb - 1);
  const int ihi = max(min(max(d.br - 1, 0), nb - 1), d.ilo);
  d.k = 31 - __clz(ihi - d.ilo + 1);
  d.bpos = ihi - (1 << d.k) + 1;
  return d;
}

// Values one warp-wide 16-byte load covers: four 4-byte values per lane.
constexpr int kPiece = 128;

// The 16-byte piece of ``row`` at positions p0..p0+3, or maxval words and no
// load when none of them lies in [lo, hi]: a lane reads only in-range
// sectors. ``row + p0`` is 16-byte aligned: the wrapper checks the base, and
// bs and p0 are multiples of 4.
template <typename T>
__device__ __forceinline__ int4 load_piece(const T* __restrict__ row, int p0, int lo, int hi) {
  if (p0 > hi || p0 + 3 < lo) {
    const int32_t big = to_word(MaxVal<T>::get());
    return make_int4(big, big, big, big);
  }
  return __ldg(reinterpret_cast<const int4*>(row + p0));
}

// One lane's candidate of one row over the range [lo, hi]: the leftmost min
// of the values it has folded, and whether an in-range one was -0.0. It
// starts as (maxval, lo), the range's first position. A lane folds its
// values in increasing position, so a strict ``<`` keeps the leftmost of
// equal values, and a masked position (maxval) never replaces the start: a
// range whose minimum is maxval answers with its first position, never with
// a masked lane left of it (the reference's masked lanes carry maxval at
// their own position and win that tie; ROADMAP.md §3). Across lanes the
// candidates merge by ``take_leftmost``.
template <typename T>
struct LaneMin {
  T v;
  int pos;
  bool neg;

  __device__ __forceinline__ explicit LaneMin(int lo) : v(MaxVal<T>::get()), pos(lo), neg(false) {}

  // The four values of one piece at positions p0..p0+3, after every
  // position this lane folded before.
  __device__ __forceinline__ void fold(int4 w, int p0, int lo, int hi) {
    const int32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + e;
      const T x = (p >= lo && p <= hi) ? from_word<T>(words[e]) : MaxVal<T>::get();
      if (x < v) {
        v = x;
        pos = p;
      }
      neg |= is_neg_zero(x);
    }
  }
};

// The partial candidate of a blocked query: the masked leftmost min of row
// bl over [ls, le] and, only when br > bl, of row br over [0, re], merged
// left over right on ties (lv <= rv: the left row holds the smaller
// indices). Two steps, so a caller can issue other loads between them:
// ``issue`` puts the first ``C`` pieces (C * 128 values) of both rows in
// flight; ``finish`` folds them, loads and folds the rest of the rows when
// bs > C * 128, reduces both rows in one set of shuffle rounds, takes each
// zero's sign from the lanes' flags and merges. Every lane ends with
// (pv, pi), pi a global index.
template <typename T, int C>
struct Partials {
  const T* rowl;
  const T* rowr;
  int bl, br, ls, le, rhi, bs;
  int4 head_l[C], head_r[C];

  __device__ __forceinline__ void issue(const T* __restrict__ xb, int bl_, int br_, int ls_,
                                        int le_, int re, int bs_, int lane) {
    bl = bl_;
    br = br_;
    bs = bs_;
    ls = ls_;
    le = min(le_, bs - 1);
    rhi = br > bl ? min(re, bs - 1) : -1;  // an empty right range unless br > bl
    rowl = xb + (long long)bl * bs;
    rowr = xb + (long long)br * bs;
    load(0, lane, head_l, head_r);
  }

  __device__ __forceinline__ void load(int base, int lane, int4 (&pl)[C], int4 (&pr)[C]) const {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int p0 = base + kPiece * j + 4 * lane;
      pl[j] = load_piece(rowl, p0, ls, le);  // le, rhi < bs: no piece past the row loads
      pr[j] = load_piece(rowr, p0, 0, rhi);
    }
  }

  __device__ __forceinline__ void fold(int base, int lane, const int4 (&pl)[C],
                                      const int4 (&pr)[C], LaneMin<T>& cl,
                                      LaneMin<T>& cr) const {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (base + kPiece * j >= bs) break;  // the same in every lane
      const int p0 = base + kPiece * j + 4 * lane;
      cl.fold(pl[j], p0, ls, le);
      cr.fold(pr[j], p0, 0, rhi);
    }
  }

  __device__ __forceinline__ void finish(int lane, T& pv, int& pi) const {
    LaneMin<T> cl(ls), cr(0);
    fold(0, lane, head_l, head_r, cl, cr);
    for (int base = kPiece * C; base < bs; base += kPiece * C) {
      int4 pl[C], pr[C];
      load(base, lane, pl, pr);
      fold(base, lane, pl, pr, cl, cr);
    }
    T lv = cl.v, rv = cr.v;
    int li = cl.pos, ri = cr.pos;
    warp_leftmost_min2(lv, li, rv, ri);
    lv = signed_zero(lv, cl.neg);
    rv = signed_zero(rv, cr.neg);
    const bool take_l = lv <= rv;
    pv = take_l ? lv : rv;
    pi = take_l ? bl * bs + li : br * bs + ri;
  }
};

// One launch answers a batch of blocked RMQs end to end: one warp per query,
// ``tile`` warps per thread block, queries past B masked (no batch padding),
// ``C`` pieces of each row in flight at once (1 at bs = 128, else 2).
// ``Cells`` is the interior. Lane 0 owns the lo cell (k, ilo), lane 1 the hi
// cell (k, bpos):
//   c = cells.load(cell)          the first-level load, issued with the rows;
//   cells.resolve(c, bs)          the hop, if any, issued before the rows
//                                 reduce;
//   cells.pick(c, bs, iv, ii)     the whole warp: lane 1's cell to lane 0 and
//                                 the lo-over-hi pick, valid in lane 0.
// A query without an interior reads no cell: its candidate is maxval, and
// the partial (never maxval from the right side, always left of int_start
// from the left side) wins the merge. The merge is the reference's
// (fused_query.py:157-169): the partial wins iff pv < iv, or pv == iv and
// its index lies left of the interior's first element.
template <typename T, int C, typename Cells>
__global__ void fused_query_kernel(const T* __restrict__ xb, Cells cells,
                                   const int32_t* __restrict__ L, const int32_t* __restrict__ R,
                                   int32_t* __restrict__ out_idx, T* __restrict__ out_val, int B,
                                   int nb, int bs_arg) {
  // At bs = 128 the block size is a constant, so the divisions of the bounds
  // and of the quantized hop's index are shifts.
  const int bs = C == 1 ? kPiece : bs_arg;
  const int lane = threadIdx.x & 31;
  const long long q = warp_query();
  if (q >= B) return;  // whole warp leaves together
  // Round trip 1: the bounds, one broadcast load each per warp.
  const Decomp d = decompose(L[q], R[q], nb, bs);

  // Round trip 2: the first-level cells and both partial rows.
  const bool own_cell = d.hasint && lane < 2;
  typename Cells::Cell c{};
  if (own_cell) c = cells.load((long long)d.k * nb + (lane == 0 ? d.ilo : d.bpos));
  Partials<T, C> part;
  part.issue(xb, d.bl, d.br, d.ls, d.le, d.re, bs, lane);

  // Round trip 3 (resident, quantized): the hop, while the rows arrive.
  if (own_cell) cells.resolve(c, bs);

  T pv;
  int pi;
  part.finish(lane, pv, pi);
  T iv = MaxVal<T>::get();
  int ii = 0;
  if (d.hasint) cells.pick(c, bs, iv, ii);
  if (lane != 0) return;

  const int int_start = (d.bl + 1) * bs;
  const bool prefer_partial = (pv < iv) || (pv == iv && pi < int_start);
  out_val[q] = prefer_partial ? pv : iv;
  out_idx[q] = prefer_partial ? pi : ii;
}

template <typename T, typename Cells>
int launch_fused_query(const void* xb, Cells cells, const void* l, const void* r, void* out_idx,
                       void* out_val, int B, int nb, int bs, int tile, void* stream) {
  const dim3 block(32 * tile);
  const dim3 grid((B + tile - 1) / tile);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bs == kPiece) {
    fused_query_kernel<T, 1, Cells><<<grid, block, 0, s>>>(
        (const T*)xb, cells, (const int32_t*)l, (const int32_t*)r, (int32_t*)out_idx,
        (T*)out_val, B, nb, bs);
  } else {
    fused_query_kernel<T, 2, Cells><<<grid, block, 0, s>>>(
        (const T*)xb, cells, (const int32_t*)l, (const int32_t*)r, (int32_t*)out_idx,
        (T*)out_val, B, nb, bs);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro
