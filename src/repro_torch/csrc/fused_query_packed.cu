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
//     (idx, val). The reference's two fetches (resident: the whole stw row;
//     dma: a window around each cell) read the same two cells; on the card
//     both names launch this one body, which reads the two cells directly.
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
//   packed64 (no Pallas body: the reference serves it through its jnp
//     query): blocks and stw are int64 words (key << 32 | global index;
//     pads are INT64_MAX), and the body is packed32's, one template over the
//     word layout (``Words32``, ``Words64``): the min of the two partial
//     rows' masked words and the two interior cells is the answer, its low
//     32 bits the index and its high 32 the key.
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
//   packed32: the first version scanned the left row in 4-byte steps and
//     reduced it, then the right row, and read the two cells only after both
//     (resident) or before the scans (dma), dividing by a runtime block size:
//     4 dependent round trips for resident, 3 for dma. Now, after the bounds,
//     the warp loads the two cells (lanes 0 and 1 keep them) and every lane
//     one 16-byte piece per 128 words of both rows, all at once (``load_words`` fills a piece that
//     misses the range with the pad word and loads nothing); each lane folds
//     its pieces and its cell into one word min, and one __reduce_min_sync
//     gives the answer (the word order breaks ties leftmost, and a word has
//     no signed zero). 2 dependent round trips for both fetches; the block
//     size is a constant at bs = 128, so the bounds' divisions are shifts.
//   packed64: the same body, so the same 2 round trips. A row of 128 words
//     is 1 KiB, so each lane loads two 16-byte pieces (two words each) of
//     both rows at once, and the warp's word min takes five 64-bit shuffles
//     (there is no 64-bit __reduce_min_sync). Per query that is up to twice
//     packed32's row bytes: at a batch of 2^26 the rows' sectors, not the
//     round trips, set the pace. Each layout keeps a kernel of its own name
//     (``fused_query_packed32_kernel``, ``fused_query_packed64_kernel``), so
//     a trace tells them apart.

#include "common.cuh"

namespace repro {

// A word layout of the packed body: its word, the 16-byte piece a lane
// loads, the pad word (packing.pad_word), the warp's word min and the
// answer's unpack (packing.unpack_idx; the key for unkey).
struct Words32 {  // packed32
  using Word = int32_t;
  using Piece = int4;
  static constexpr int kWords = 4;  // words a piece holds
  static constexpr Word kPad = 0x7fffffff;
  __device__ static void words(Piece p, Word (&w)[kWords]) {
    w[0] = p.x;
    w[1] = p.y;
    w[2] = p.z;
    w[3] = p.w;
  }
  __device__ static Piece pad() { return make_int4(kPad, kPad, kPad, kPad); }
  __device__ static Word warp_min(Word w) { return __reduce_min_sync(kFullMask, w); }
  __device__ static int32_t index(Word w, int idx_bits) { return w & ((1 << idx_bits) - 1); }
  // Unsigned add: a pad word's garbage key must wrap, not overflow (it never
  // wins a min over a non-empty range, as in the reference's unpack_val).
  __device__ static int32_t key(Word w, int idx_bits, int kmin) {
    return (int32_t)((uint32_t)(w >> idx_bits) + (uint32_t)kmin);
  }
};

struct Words64 {  // packed64
  using Word = long long;
  using Piece = longlong2;
  static constexpr int kWords = 2;
  static constexpr Word kPad = 0x7fffffffffffffffLL;
  __device__ static void words(Piece p, Word (&w)[kWords]) {
    w[0] = p.x;
    w[1] = p.y;
  }
  __device__ static Piece pad() { return make_longlong2(kPad, kPad); }
  // No 64-bit __reduce_min_sync: five shuffles.
  __device__ static Word warp_min(Word w) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w = min(w, __shfl_xor_sync(kFullMask, w, off));
    return w;
  }
  __device__ static int32_t index(Word w, int) { return (int32_t)(w & 0xffffffffLL); }
  __device__ static int32_t key(Word w, int, int) { return (int32_t)(w >> 32); }  // no bias
};

// The 16-byte piece of ``row`` at positions p0..p0 + kWords - 1, or pad
// words and no load when none of them lies in [lo, hi].
template <class W>
__device__ __forceinline__ typename W::Piece load_words(const typename W::Word* __restrict__ row,
                                                        int p0, int lo, int hi) {
  if (p0 > hi || p0 + W::kWords - 1 < lo) return W::pad();
  return __ldg(reinterpret_cast<const typename W::Piece*>(row + p0));
}

// The least of one piece's words that lie in [lo, hi]; the pad word when
// none does.
template <class W>
__device__ __forceinline__ typename W::Word piece_word_min(typename W::Piece p, int p0, int lo,
                                                           int hi) {
  typename W::Word words[W::kWords];
  W::words(p, words);
  typename W::Word m = W::kPad;
#pragma unroll
  for (int e = 0; e < W::kWords; ++e) {
    if (p0 + e >= lo && p0 + e <= hi) m = min(m, words[e]);
  }
  return m;
}

// Decode one word's key field (packing.unpack_val).
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

// The packed body, both fetches and both word layouts: ``C`` pieces of each
// row in flight at once per lane; ``BS`` the block size when it is a
// constant (128), 0 for a runtime one.
template <class W, typename T, int C, int BS>
__device__ __forceinline__ void packed_query(const typename W::Word* __restrict__ blocks,
                                             const typename W::Word* __restrict__ stw,
                                             const int32_t* __restrict__ L,
                                             const int32_t* __restrict__ R,
                                             int32_t* __restrict__ out_idx, T* __restrict__ out_val,
                                             int B, int nb, int bs_arg, int idx_bits, int kmin) {
  using Word = typename W::Word;
  constexpr int kSpan = 32 * W::kWords;  // words one warp-wide load covers
  const int bs = BS ? BS : bs_arg;
  const int lane = threadIdx.x & 31;
  const long long q = warp_query();
  if (q >= B) return;  // whole warp leaves together
  // Round trip 1: the bounds, one broadcast load each per warp.
  const Decomp d = decompose(L[q], R[q], nb, bs);
  const int le = min(d.le, bs - 1);
  const int rhi = d.br > d.bl ? min(d.re, bs - 1) : -1;  // no right range unless br > bl
  const Word* rowl = blocks + (long long)d.bl * bs;
  const Word* rowr = blocks + (long long)d.br * bs;

  // Round trip 2: the two interior cells (lane 0 the lo cell, every other
  // lane the hi cell) and both rows. The cell load is unconditional (the
  // clamped cells always lie in stw): behind a branch, the compiler sank it
  // past the rows' fold, a third round trip.
  const Word cell = __ldg(stw + (long long)d.k * nb + (lane == 0 ? d.ilo : d.bpos));
  Word w = W::kPad;
  for (int base = 0; base < bs; base += kSpan * C) {
    typename W::Piece pl[C], pr[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int p0 = base + kSpan * j + W::kWords * lane;
      pl[j] = load_words<W>(rowl, p0, d.ls, le);  // le, rhi < bs: no piece past the row loads
      pr[j] = load_words<W>(rowr, p0, 0, rhi);
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int p0 = base + kSpan * j + W::kWords * lane;
      w = min(w, min(piece_word_min<W>(pl[j], p0, d.ls, le), piece_word_min<W>(pr[j], p0, 0, rhi)));
    }
  }
  if (d.hasint && lane < 2) w = min(w, cell);
  w = W::warp_min(w);
  if (lane != 0) return;
  out_idx[q] = W::index(w, idx_bits);
  out_val[q] = unkey<T>(W::key(w, idx_bits, kmin));
}

// The two layouts' kernels, one name each in a trace. packed32: one piece
// of each row (128 words) at bs = 128, where the block size is a constant,
// else 2. packed64: two pieces of each row (128 words) a round.
template <typename T, int C>
__global__ void __launch_bounds__(1024)
    fused_query_packed32_kernel(const int32_t* __restrict__ blocks,
                                const int32_t* __restrict__ stw, const int32_t* __restrict__ L,
                                const int32_t* __restrict__ R, int32_t* __restrict__ out_idx,
                                T* __restrict__ out_val, int B, int nb, int bs_arg, int idx_bits,
                                int kmin) {
  packed_query<Words32, T, C, C == 1 ? kPiece : 0>(blocks, stw, L, R, out_idx, out_val, B, nb,
                                                   bs_arg, idx_bits, kmin);
}

template <typename T, int BS>
__global__ void __launch_bounds__(1024)
    fused_query_packed64_kernel(const long long* __restrict__ blocks,
                                const long long* __restrict__ stw,
                                const int32_t* __restrict__ L, const int32_t* __restrict__ R,
                                int32_t* __restrict__ out_idx, T* __restrict__ out_val, int B,
                                int nb, int bs_arg) {
  packed_query<Words64, T, 2, BS>(blocks, stw, L, R, out_idx, out_val, B, nb, bs_arg, 0, 0);
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

// ``dma`` is the reference's fetch name: both fetches read the same two
// cells, so both launch the same body.
template <typename T>
static int launch_packed32(const void* blocks, const void* stw, const void* l, const void* r,
                           void* out_idx, void* out_val, int B, int nb, int bs, int idx_bits,
                           int kmin, int /*dma*/, int tile, void* stream) {
  const dim3 block(32 * tile);
  const dim3 grid((B + tile - 1) / tile);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bs == kPiece) {
    fused_query_packed32_kernel<T, 1><<<grid, block, 0, s>>>(
        (const int32_t*)blocks, (const int32_t*)stw, (const int32_t*)l, (const int32_t*)r,
        (int32_t*)out_idx, (T*)out_val, B, nb, bs, idx_bits, kmin);
  } else {
    fused_query_packed32_kernel<T, 2><<<grid, block, 0, s>>>(
        (const int32_t*)blocks, (const int32_t*)stw, (const int32_t*)l, (const int32_t*)r,
        (int32_t*)out_idx, (T*)out_val, B, nb, bs, idx_bits, kmin);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_packed64(const void* blocks, const void* stw, const void* l, const void* r,
                           void* out_idx, void* out_val, int B, int nb, int bs, int tile,
                           void* stream) {
  const dim3 block(32 * tile);
  const dim3 grid((B + tile - 1) / tile);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bs == kPiece) {
    fused_query_packed64_kernel<T, kPiece><<<grid, block, 0, s>>>(
        (const long long*)blocks, (const long long*)stw, (const int32_t*)l, (const int32_t*)r,
        (int32_t*)out_idx, (T*)out_val, B, nb, bs);
  } else {
    fused_query_packed64_kernel<T, 0><<<grid, block, 0, s>>>(
        (const long long*)blocks, (const long long*)stw, (const int32_t*)l, (const int32_t*)r,
        (int32_t*)out_idx, (T*)out_val, B, nb, bs);
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

extern "C" int repro_fused_query_packed64_f32(const void* blocks, const void* stw, const void* l,
                                              const void* r, void* out_idx, void* out_val, int B,
                                              int nb, int bs, int tile, void* stream) {
  return repro::launch_packed64<float>(blocks, stw, l, r, out_idx, out_val, B, nb, bs, tile,
                                       stream);
}

extern "C" int repro_fused_query_packed64_i32(const void* blocks, const void* stw, const void* l,
                                              const void* r, void* out_idx, void* out_val, int B,
                                              int nb, int bs, int tile, void* stream) {
  return repro::launch_packed64<int32_t>(blocks, stw, l, r, out_idx, out_val, B, nb, bs, tile,
                                         stream);
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
