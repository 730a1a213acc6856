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
// (lv <= rv); the interior value is ``jnp.minimum`` of the two cells (-0.0
// below +0.0) and its index the lo cell's on ties; the partial wins over
// the interior iff pv < iv, or pv == iv and its index lies left of the
// interior's first block.
//
//   fetch dma:      the value-augmented tables st_val / st_gidx hold each
//                   cell's value and global index: lanes 0 and 1 load them
//                   together with the rows.
//   fetch resident: st_idx[k, .] gives block ids, and their values and
//                   global indices come from bmin_val / bmin_gidx: the hop,
//                   issued while the rows arrive.
//
// Bound: per query, the elements of its one or two partial ranges, the
// interior cells, 8 bytes of bounds and one (idx, val) written; at B = 4096,
// bs = 128, float32, with both partial rows whole, about 4.8 MB, 1.4 us at
// 3.35 TB/s. A batch cannot keep the card's memory busy: the chain of
// dependent round trips per query bounds it.
//
// What held the first version back, and the design now: the shared body
// (``fused_query_kernel`` of common.cuh, which the quantized packed body
// shares) used to walk the left row, then the right row, in 4-byte steps,
// and only then read the cells from lane 0: 4 dependent round trips for dma,
// 5 for resident. It now issues the cells and both rows in 16-byte pieces
// at once, the hop right after: written for 2 round trips for dma and 3 for
// resident, 3 for dma in the SASS (common.cuh). This file holds the two
// interiors.

#include "common.cuh"

namespace repro {

// The lo cell covers [ilo, ilo + 2^k), which starts at or before the hi
// cell's [bpos, ihi]: its index wins on equal values. The value is the
// reference's ``jnp.minimum`` of the two (-0.0 below +0.0).
template <typename T>
__device__ __forceinline__ void pick_lo(T av, int ai, T& v, int& i) {
  const T bv = __shfl_sync(kFullMask, av, 1);
  const int bi = __shfl_sync(kFullMask, ai, 1);
  v = signed_min(av, bv);
  i = av <= bv ? ai : bi;
}

template <typename T>
struct DmaCells {
  const T* __restrict__ st_val;
  const int32_t* __restrict__ st_gidx;
  struct Cell {
    T v;
    int i;
  };
  __device__ __forceinline__ Cell load(long long cell) const {
    return {st_val[cell], st_gidx[cell]};
  }
  __device__ __forceinline__ void resolve(Cell&, int) const {}
  __device__ __forceinline__ void pick(const Cell& c, int, T& v, int& i) const {
    pick_lo(c.v, c.i, v, i);
  }
};

template <typename T>
struct ResidentCells {
  const int32_t* __restrict__ st_idx;
  const T* __restrict__ bmin_val;
  const int32_t* __restrict__ bmin_gidx;
  struct Cell {
    int block;
    T v;
    int i;
  };
  __device__ __forceinline__ Cell load(long long cell) const { return {st_idx[cell], T(), 0}; }
  __device__ __forceinline__ void resolve(Cell& c, int) const {
    c.v = bmin_val[c.block];
    c.i = bmin_gidx[c.block];
  }
  __device__ __forceinline__ void pick(const Cell& c, int, T& v, int& i) const {
    pick_lo(c.v, c.i, v, i);
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
