// fused_query: one launch answers a batch of blocked RMQs end to end.
//
// Replaces the Pallas TPU megakernel ``fused_query`` of
// src/repro/kernels/fused_query.py (body ``_kernel``), both fetch
// strategies. On the TPU the per-query scalars (bl, br, ls, le, re, k, ilo,
// bpos, hasint) were computed on the host because scalar prefetch needed
// them before the grid ran; here each warp computes its own, with
// k = floor(log2(ihi - ilo + 1)) taken exactly as 31 - clz.
//
// Per query: the left partial is the masked min over x_blocks[bl, ls..le]
// (le = re when bl == br, else bs-1), the right partial the masked min over
// x_blocks[br, 0..re] (only when br > bl), the interior (when br - bl >= 2)
// the two doubling-table cells at (k, ilo) and (k, bpos), and the merges are
// those of the reference (fused_query.py:157-169): left over right on ties
// (lv <= rv); the cell at ilo over the cell at bpos on ties; the partial over
// the interior iff pv < iv, or pv == iv and its index lies left of the
// interior's first block.
//
//   fetch resident: st_idx[k, .] gives block ids whose value and global index
//                   come from bmin_val / bmin_gidx (two dependent loads);
//   fetch dma:      the value-augmented tables st_val / st_gidx hold them at
//                   the same two cells (one load).
//
// Bound: per query, the elements of its one or two partial ranges, the
// interior cells, 8 bytes of bounds and one (idx, val) written; at B = 4096,
// bs = 128, float32, with both partial rows whole, about 4.8 MB, 1.4 us at
// 3.35 TB/s. The loads are dependent and scattered (each query touches its
// own rows and table cells), so latency, not bandwidth, is expected to bound
// this simple version.
//
// Design: one warp per query, ``tile`` queries (warps) per thread block
// (``fused_query_kernel`` of common.cuh, which the quantized packed body
// shares). The lanes stride the row (coalesced reads; lanes outside the
// range skip the load and carry maxval, exactly the reference's masked
// lanes), then a shuffle reduction over (value, lane) keeps the lower lane
// on equal values. This file holds the two interiors.

#include "common.cuh"

namespace repro {

// The lo cell covers [ilo, ilo + 2^k), which starts at or before the hi
// cell's [bpos, ihi]: prefer lo on equal values.
template <typename T>
__device__ __forceinline__ void pick_lo(T av, int ai, T bv, int bi, T& v, int& i) {
  const bool take_lo = av <= bv;
  v = take_lo ? av : bv;
  i = take_lo ? ai : bi;
}

template <typename T>
struct ResidentCells {
  const int32_t* __restrict__ st_idx;
  const T* __restrict__ bmin_val;
  const int32_t* __restrict__ bmin_gidx;
  __device__ __forceinline__ void operator()(long long c_lo, long long c_hi, int, T& v,
                                             int& i) const {
    const int a = st_idx[c_lo];
    const int b = st_idx[c_hi];
    pick_lo(bmin_val[a], bmin_gidx[a], bmin_val[b], bmin_gidx[b], v, i);
  }
};

template <typename T>
struct DmaCells {
  const T* __restrict__ st_val;
  const int32_t* __restrict__ st_gidx;
  __device__ __forceinline__ void operator()(long long c_lo, long long c_hi, int, T& v,
                                             int& i) const {
    pick_lo(st_val[c_lo], st_gidx[c_lo], st_val[c_hi], st_gidx[c_hi], v, i);
  }
};

template <typename T>
static int launch(const void* xb, const void* bmin_val, const void* bmin_gidx, const void* st_idx,
                  const void* st_val, const void* st_gidx, const void* l, const void* r,
                  void* out_idx, void* out_val, int B, int nb, int bs, int dma, int tile,
                  void* stream) {
  if (dma) {
    const DmaCells<T> cells{(const T*)st_val, (const int32_t*)st_gidx};
    return launch_fused_query<T>(xb, cells, l, r, out_idx, out_val, B, nb, bs, tile, stream);
  }
  const ResidentCells<T> cells{(const int32_t*)st_idx, (const T*)bmin_val,
                               (const int32_t*)bmin_gidx};
  return launch_fused_query<T>(xb, cells, l, r, out_idx, out_val, B, nb, bs, tile, stream);
}

}  // namespace repro

extern "C" int repro_fused_query_f32(const void* xb, const void* bmin_val, const void* bmin_gidx,
                                     const void* st_idx, const void* st_val, const void* st_gidx,
                                     const void* l, const void* r, void* out_idx, void* out_val,
                                     int B, int nb, int bs, int dma, int tile, void* stream) {
  return repro::launch<float>(xb, bmin_val, bmin_gidx, st_idx, st_val, st_gidx, l, r, out_idx,
                              out_val, B, nb, bs, dma, tile, stream);
}

extern "C" int repro_fused_query_i32(const void* xb, const void* bmin_val, const void* bmin_gidx,
                                     const void* st_idx, const void* st_val, const void* st_gidx,
                                     const void* l, const void* r, void* out_idx, void* out_val,
                                     int B, int nb, int bs, int dma, int tile, void* stream) {
  return repro::launch<int32_t>(xb, bmin_val, bmin_gidx, st_idx, st_val, st_gidx, l, r, out_idx,
                                out_val, B, nb, bs, dma, tile, stream);
}
