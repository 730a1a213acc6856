// fused_query_packed: one launch answers a batch of blocked RMQs over packed
// (value, index) word structures (core/packing.py).
//
// Replaces the Pallas TPU megakernel ``fused_query_packed`` of
// src/repro/kernels/fused_query.py, both bodies:
//
//   packed32 (``_kernel_packed``): blocks and stw are int32 words
//     ((key - kmin) << idx_bits | global index; pads are INT32_MAX). The
//     left partial is the masked word min of blocks[bl, ls..le], the right
//     the masked word min of blocks[br, 0..re] (only when br > bl), the
//     interior min(stw[k, ilo], stw[k, bpos]) (only when br - bl >= 2); the
//     answer is the min of the three words, which IS the leftmost minimum.
//     The kernel unpacks it (packing.unpack_idx / unpack_val) and writes
//     (idx, val). Two fetches, as in the reference:
//       resident: lane 0 reads the two interior cells after the partial
//                 scans (the loads depend on nothing but wait behind them);
//       dma:      lanes 0 and 1 issue the two cell loads before the scans,
//                 so their latency overlaps the row reads (the TPU's DMA
//                 windows, which also overlapped the partial compute).
//     Both read the same cells and give the same bits.
//   quantized (``_kernel_quantized``): blocks are raw values (maxval-padded)
//     and the kernel is ``fused_query_kernel`` of common.cuh (fused_query.cu's
//     body) with its own interior cells; stw holds (bucket << idx_bits |
//     exact argmin index) words. The interior takes both cells' exact values
//     from the resident plane bmin_val[idx / bs] (an interior cell's argmin
//     is the minimum of its own fully covered block); on a bucket tie the
//     exact values decide (lo cell on equal values), otherwise the word order
//     does. Without an interior the cells are not read and iv = maxval, so
//     the partial wins the merge exactly as in the reference (see
//     common.cuh).
//
// Bound: per query, the elements of its one or two partial rows, two interior
// cells (packed32: 2 words; quantized: 2 words + 2 values), 8 bytes of bounds
// and one (idx, val) written. At B = 4096 that is under 5 MB, about 1.4 us at
// 3.35 TB/s; a batch cannot keep the card's memory busy, so the chain of
// dependent round trips per query bounds both bodies.
//
// Design: one warp per query, ``tile`` warps per thread block, queries past B
// masked (no batch padding), the per-query scalars from common.cuh's
// ``decompose`` (block ids clamped).
//   quantized: what held the first version back was the shared body's chain
//     (bounds; left row in 4-byte steps; right row; then lane 0's two stw
//     words; then their two block minima: 5 dependent round trips). Lanes 0
//     and 1 now load the two stw words together with both rows (16-byte
//     pieces), and each issues its own bmin_val hop before the rows reduce:
//     3 round trips (common.cuh).
//   packed32: the word scans still step 4 bytes at a time, one row after the
//     other, and reduce with __reduce_min_sync (the word order already breaks
//     ties leftmost); giving them the pieces of common.cuh is later work.

#include "common.cuh"

namespace repro {

__device__ __forceinline__ int32_t word_row_min(const int32_t* __restrict__ row, int lo, int hi,
                                                int bs, int lane) {
  int32_t w = 0x7fffffff;  // pad_word of packed32
  for (int p = lane; p < bs; p += 32) {
    if (p >= lo && p <= hi) w = min(w, row[p]);
  }
  return __reduce_min_sync(0xffffffffu, w);
}

// Decode one packed32 word's value field (packing.unpack_val).
template <typename T>
__device__ __forceinline__ T unkey(int32_t key);
template <>
__device__ __forceinline__ float unkey<float>(int32_t key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}
template <>
__device__ __forceinline__ int32_t unkey<int32_t>(int32_t key) {
  return key;
}

template <typename T, bool kDma>
__global__ void fused_query_packed32_kernel(const int32_t* __restrict__ blocks,
                                            const int32_t* __restrict__ stw,
                                            const int32_t* __restrict__ L,
                                            const int32_t* __restrict__ R,
                                            int32_t* __restrict__ out_idx, T* __restrict__ out_val,
                                            int B, int nb, int bs, int idx_bits, int kmin) {
  const int lane = threadIdx.x & 31;
  const long long q = warp_query();
  if (q >= B) return;  // whole warp leaves together
  const int32_t pad = 0x7fffffff;
  const Decomp d = decompose(L[q], R[q], nb, bs);
  const long long c_lo = (long long)d.k * nb + d.ilo;
  const long long c_hi = (long long)d.k * nb + d.bpos;

  int32_t cell = pad;
  if (kDma && d.hasint && lane < 2) cell = stw[lane == 0 ? c_lo : c_hi];

  int32_t w = word_row_min(blocks + (long long)d.bl * bs, d.ls, d.le, bs, lane);
  if (d.br > d.bl) w = min(w, word_row_min(blocks + (long long)d.br * bs, 0, d.re, bs, lane));

  int32_t iw = pad;
  if (kDma) {
    const int32_t other = __shfl_sync(0xffffffffu, cell, 1);
    iw = min(cell, other);
  }
  if (lane != 0) return;
  if (!kDma && d.hasint) iw = min(stw[c_lo], stw[c_hi]);
  w = min(w, iw);
  out_idx[q] = w & ((1 << idx_bits) - 1);
  // Unsigned add: a pad word's garbage key must wrap, not overflow (it never
  // wins a min over a non-empty range, as in the reference's unpack_val).
  out_val[q] = unkey<T>((int32_t)((uint32_t)(w >> idx_bits) + (uint32_t)kmin));
}

// The quantized interior: (bucket << idx_bits | exact argmin) words at both
// cells; an interior cell's argmin is the minimum of its own fully covered
// block, so bmin_val[idx / bs] is its exact value (the hop). On a bucket tie
// the exact values decide (lo cell on equal values), otherwise the word order
// does.
template <typename T>
struct QuantizedCells {
  const int32_t* __restrict__ stw;
  const T* __restrict__ bmin_val;
  int idx_bits;
  struct Cell {
    int32_t w;
    T v;
  };
  __device__ __forceinline__ Cell load(long long cell) const { return {stw[cell], T()}; }
  __device__ __forceinline__ void resolve(Cell& c, int bs) const {
    c.v = bmin_val[(c.w & ((1 << idx_bits) - 1)) / bs];
  }
  __device__ __forceinline__ void pick(const Cell& c, int, T& v, int& i) const {
    const int32_t wb = __shfl_sync(kFullMask, c.w, 1);
    const T vb = __shfl_sync(kFullMask, c.v, 1);
    const bool collide = (c.w >> idx_bits) == (wb >> idx_bits);
    const bool take_a = collide ? (c.v <= vb) : (c.w <= wb);
    v = take_a ? c.v : vb;
    i = (take_a ? c.w : wb) & ((1 << idx_bits) - 1);
  }
};

template <typename T>
static int launch_packed32(const void* blocks, const void* stw, const void* l, const void* r,
                           void* out_idx, void* out_val, int B, int nb, int bs, int idx_bits,
                           int kmin, int dma, int tile, void* stream) {
  const dim3 block(32 * tile);
  const dim3 grid((B + tile - 1) / tile);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dma) {
    fused_query_packed32_kernel<T, true><<<grid, block, 0, s>>>(
        (const int32_t*)blocks, (const int32_t*)stw, (const int32_t*)l, (const int32_t*)r,
        (int32_t*)out_idx, (T*)out_val, B, nb, bs, idx_bits, kmin);
  } else {
    fused_query_packed32_kernel<T, false><<<grid, block, 0, s>>>(
        (const int32_t*)blocks, (const int32_t*)stw, (const int32_t*)l, (const int32_t*)r,
        (int32_t*)out_idx, (T*)out_val, B, nb, bs, idx_bits, kmin);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_quantized(const void* blocks, const void* stw, const void* bmin_val,
                            const void* l, const void* r, void* out_idx, void* out_val, int B,
                            int nb, int bs, int idx_bits, int tile, void* stream) {
  const QuantizedCells<T> cells{(const int32_t*)stw, (const T*)bmin_val, idx_bits};
  return launch_fused_query<T>(blocks, cells, l, r, out_idx, out_val, B, nb, bs, tile, stream);
}

}  // namespace repro

extern "C" int repro_fused_query_packed32_f32(const void* blocks, const void* stw, const void* l,
                                              const void* r, void* out_idx, void* out_val, int B,
                                              int nb, int bs, int idx_bits, int kmin, int dma,
                                              int tile, void* stream) {
  return repro::launch_packed32<float>(blocks, stw, l, r, out_idx, out_val, B, nb, bs, idx_bits,
                                       kmin, dma, tile, stream);
}

extern "C" int repro_fused_query_packed32_i32(const void* blocks, const void* stw, const void* l,
                                              const void* r, void* out_idx, void* out_val, int B,
                                              int nb, int bs, int idx_bits, int kmin, int dma,
                                              int tile, void* stream) {
  return repro::launch_packed32<int32_t>(blocks, stw, l, r, out_idx, out_val, B, nb, bs, idx_bits,
                                         kmin, dma, tile, stream);
}

extern "C" int repro_fused_query_quantized_f32(const void* blocks, const void* stw,
                                               const void* bmin_val, const void* l, const void* r,
                                               void* out_idx, void* out_val, int B, int nb, int bs,
                                               int idx_bits, int tile, void* stream) {
  return repro::launch_quantized<float>(blocks, stw, bmin_val, l, r, out_idx, out_val, B, nb, bs,
                                        idx_bits, tile, stream);
}

extern "C" int repro_fused_query_quantized_i32(const void* blocks, const void* stw,
                                               const void* bmin_val, const void* l, const void* r,
                                               void* out_idx, void* out_val, int B, int nb, int bs,
                                               int idx_bits, int tile, void* stream) {
  return repro::launch_quantized<int32_t>(blocks, stw, bmin_val, l, r, out_idx, out_val, B, nb,
                                          bs, idx_bits, tile, stream);
}
