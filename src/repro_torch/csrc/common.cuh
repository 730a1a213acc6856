// Shared device helpers of the RMQ kernels: the padding value of each value
// type, the leftmost warp reduction, the sign of a zero minimum, the masked
// leftmost min of one row, the per-query decomposition, and the fused
// blocked-query kernel that fused_query.cu and fused_query_packed.cu
// instantiate with their interior cells.
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

// The sign of a zero minimum. The reference kernels' ``vmin = jnp.min(row)``
// is -0.0 when the minimum is zero and a -0.0 takes part, whichever zero
// comes first; the pair reduction above keeps the leftmost zero's bits. When
// (and only when) the warp's minimum ``v`` is a zero, its lanes scan
// row[lo..hi] again for a -0.0 and vote: rows with a nonzero minimum pay one
// compare. Integers have one zero.
__device__ __forceinline__ int32_t zero_sign(const int32_t*, int, int, int, int, int32_t v) {
  return v;
}
__device__ __forceinline__ float zero_sign(const float* __restrict__ row, int lo, int hi, int bs,
                                           int lane, float v) {
  if (v != 0.0f) return v;  // the same v in every lane: the warp branches together
  bool neg = false;
  for (int p = lane; p < bs; p += 32) {
    if (p >= lo && p <= hi) neg |= __float_as_int(row[p]) == (int)0x80000000;
  }
  return __any_sync(0xffffffffu, neg) ? -0.0f : 0.0f;
}

// Masked leftmost min of row[lo..hi] by one warp: lane t reads elements t,
// t+32, ... (one coalesced 128-byte read per step for 4-byte values); lanes
// outside [lo, hi] skip the load and carry maxval at their own position,
// exactly the reference's masked lanes, so even a range whose minimum is
// maxval resolves as ``min(where(x == vmin, iota, bs))`` does, and the value
// is ``jnp.min``'s (zero_sign). Every lane ends with the pair.
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
  v = zero_sign(row, lo, hi, bs, lane, v);
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

// The partial candidate of a blocked query: the masked leftmost min of
// row bl over [ls, le] and, only when br > bl, of row br over [0, re],
// merged left over right on ties (lv <= rv: the left row holds the smaller
// indices). Every lane ends with (pv, pi), pi a global index.
template <typename T>
__device__ __forceinline__ void partials(const T* __restrict__ xb, int bl, int br, int ls, int le,
                                         int re, int bs, int lane, T& pv, int& pi) {
  T lv;
  int li;
  row_min(xb + (long long)bl * bs, ls, le, bs, lane, lv, li);
  T rv = MaxVal<T>::get();
  int ri = bs;
  if (br > bl) row_min(xb + (long long)br * bs, 0, re, bs, lane, rv, ri);
  const bool take_l = lv <= rv;
  pv = take_l ? lv : rv;
  pi = take_l ? bl * bs + li : br * bs + ri;
}

// One launch answers a batch of blocked RMQs end to end: one warp per query,
// ``tile`` warps per thread block, queries past B masked (no batch padding).
// ``Cells`` reads the interior candidate from the doubling-table cells at
// c_lo = (k, ilo) and c_hi = (k, bpos): ``cells(c_lo, c_hi, bs, iv, ii)``,
// called by lane 0 only for a query with an interior. Without an interior
// the candidate is maxval and the partial (never maxval from the right side,
// always left of int_start from the left side) wins the merge, so the cells
// need no read. The merge is the reference's (fused_query.py:157-169): the
// partial wins iff pv < iv, or pv == iv and its index lies left of the
// interior's first element.
template <typename T, typename Cells>
__global__ void fused_query_kernel(const T* __restrict__ xb, Cells cells,
                                   const int32_t* __restrict__ L, const int32_t* __restrict__ R,
                                   int32_t* __restrict__ out_idx, T* __restrict__ out_val, int B,
                                   int nb, int bs) {
  const int lane = threadIdx.x & 31;
  const long long q = warp_query();
  if (q >= B) return;  // whole warp leaves together
  const Decomp d = decompose(L[q], R[q], nb, bs);
  T pv;
  int pi;
  partials(xb, d.bl, d.br, d.ls, d.le, d.re, bs, lane, pv, pi);
  if (lane != 0) return;

  T iv = MaxVal<T>::get();
  int ii = 0;
  if (d.hasint) cells((long long)d.k * nb + d.ilo, (long long)d.k * nb + d.bpos, bs, iv, ii);

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
  fused_query_kernel<T, Cells><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)xb, cells, (const int32_t*)l, (const int32_t*)r, (int32_t*)out_idx, (T*)out_val,
      B, nb, bs);
  return (int)cudaGetLastError();
}

}  // namespace repro
