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
// Design: one warp per query, ``tile`` queries (warps) per thread block. The
// lanes stride the row (coalesced reads; lanes outside the range skip the
// load and carry maxval, exactly the reference's masked lanes), then a
// shuffle reduction over (value, lane) keeps the lower lane on equal values.
// Queries past B are masked, so the batch needs no padding to a tile
// multiple. Block ids are clamped to [0, nb) so a malformed bound can never
// read outside the tensors; valid bounds are never changed by the clamp.

#include "common.cuh"

namespace repro {

template <typename T>
__device__ __forceinline__ void row_min(const T* __restrict__ row, int lo, int hi, int bs,
                                        int lane, T& v, int& pos) {
  const T big = MaxVal<T>::get();
  v = big;
  pos = bs;
  for (int p = lane; p < bs; p += 32) {
    const T x = (p >= lo && p <= hi) ? row[p] : big;
    if (x < v || (x == v && p < pos)) {
      v = x;
      pos = p;
    }
  }
  warp_leftmost_min(v, pos);
}

template <typename T, bool kDma>
__global__ void fused_query_kernel(const T* __restrict__ xb, const T* __restrict__ bmin_val,
                                   const int32_t* __restrict__ bmin_gidx,
                                   const int32_t* __restrict__ st_idx,
                                   const T* __restrict__ st_val,
                                   const int32_t* __restrict__ st_gidx,
                                   const int32_t* __restrict__ L, const int32_t* __restrict__ R,
                                   int32_t* __restrict__ out_idx, T* __restrict__ out_val, int B,
                                   int nb, int bs) {
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= B) return;  // whole warp leaves together
  const T big = MaxVal<T>::get();

  // Scalar decomposition (the host side of fused_query.py:224-237).
  const int l = L[q], r = R[q];
  const int bl = min(max(l / bs, 0), nb - 1);
  const int br = min(max(r / bs, 0), nb - 1);
  const int ls = l - bl * bs;
  const int re = r - br * bs;
  const int le = (bl == br) ? re : bs - 1;
  const bool hasint = (br - bl) >= 2;
  const int ilo = min(max(bl + 1, 0), nb - 1);
  const int ihi = max(min(max(br - 1, 0), nb - 1), ilo);
  const int k = 31 - __clz(ihi - ilo + 1);
  const int bpos = ihi - (1 << k) + 1;

  // Partials: masked leftmost min over each row.
  T lv;
  int li;
  row_min(xb + (long long)bl * bs, ls, le, bs, lane, lv, li);
  T rv = big;
  int ri = bs;
  if (br > bl) row_min(xb + (long long)br * bs, 0, re, bs, lane, rv, ri);

  if (lane != 0) return;
  const int lg = bl * bs + li;
  const int rg = br * bs + ri;
  const bool take_l = lv <= rv;
  const T pv = take_l ? lv : rv;
  const int pi = take_l ? lg : rg;

  // Interior candidate. Without an interior it is maxval, and the partial
  // (never maxval from the right side, always left of int_start from the
  // left side) wins the merge below, so the cells need no read.
  T iv = big;
  int ii = 0;
  if (hasint) {
    const long long c_lo = (long long)k * nb + ilo;
    const long long c_hi = (long long)k * nb + bpos;
    T av, bv;
    int ai, bi;
    if (kDma) {
      av = st_val[c_lo];
      bv = st_val[c_hi];
      ai = st_gidx[c_lo];
      bi = st_gidx[c_hi];
    } else {
      const int a = st_idx[c_lo];
      const int b = st_idx[c_hi];
      av = bmin_val[a];
      bv = bmin_val[b];
      ai = bmin_gidx[a];
      bi = bmin_gidx[b];
    }
    // The lo cell covers [ilo, ilo + 2^k), which starts at or before the hi
    // cell's [bpos, ihi]: prefer lo on equal values.
    const bool take_lo = av <= bv;
    iv = take_lo ? av : bv;
    ii = take_lo ? ai : bi;
  }

  const int int_start = (bl + 1) * bs;
  const bool prefer_partial = (pv < iv) || (pv == iv && pi < int_start);
  out_val[q] = prefer_partial ? pv : iv;
  out_idx[q] = prefer_partial ? pi : ii;
}

template <typename T>
static int launch_fused_query(const void* xb, const void* bmin_val, const void* bmin_gidx,
                              const void* st_idx, const void* st_val, const void* st_gidx,
                              const void* l, const void* r, void* out_idx, void* out_val, int B,
                              int nb, int bs, int dma, int tile, void* stream) {
  const dim3 block(32 * tile);
  const dim3 grid((B + tile - 1) / tile);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dma) {
    fused_query_kernel<T, true><<<grid, block, 0, s>>>(
        (const T*)xb, (const T*)bmin_val, (const int32_t*)bmin_gidx, (const int32_t*)st_idx,
        (const T*)st_val, (const int32_t*)st_gidx, (const int32_t*)l, (const int32_t*)r,
        (int32_t*)out_idx, (T*)out_val, B, nb, bs);
  } else {
    fused_query_kernel<T, false><<<grid, block, 0, s>>>(
        (const T*)xb, (const T*)bmin_val, (const int32_t*)bmin_gidx, (const int32_t*)st_idx,
        (const T*)st_val, (const int32_t*)st_gidx, (const int32_t*)l, (const int32_t*)r,
        (int32_t*)out_idx, (T*)out_val, B, nb, bs);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_fused_query_f32(const void* xb, const void* bmin_val, const void* bmin_gidx,
                                     const void* st_idx, const void* st_val, const void* st_gidx,
                                     const void* l, const void* r, void* out_idx, void* out_val,
                                     int B, int nb, int bs, int dma, int tile, void* stream) {
  return repro::launch_fused_query<float>(xb, bmin_val, bmin_gidx, st_idx, st_val, st_gidx, l, r,
                                          out_idx, out_val, B, nb, bs, dma, tile, stream);
}

extern "C" int repro_fused_query_i32(const void* xb, const void* bmin_val, const void* bmin_gidx,
                                     const void* st_idx, const void* st_val, const void* st_gidx,
                                     const void* l, const void* r, void* out_idx, void* out_val,
                                     int B, int nb, int bs, int dma, int tile, void* stream) {
  return repro::launch_fused_query<int32_t>(xb, bmin_val, bmin_gidx, st_idx, st_val, st_gidx, l,
                                            r, out_idx, out_val, B, nb, bs, dma, tile, stream);
}
