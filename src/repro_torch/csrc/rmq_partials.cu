// rmq_partials: the left and right partial-block candidates of a batch of
// blocked RMQs, merged left-first (the first pass of ops.query(fused=False)).
//
// Replaces the Pallas TPU kernel ``rmq_partials`` of
// src/repro/kernels/rmq_query.py (body ``_kernel``), which stacked ``tile``
// left rows and ``tile`` right rows in VMEM and took two masked mins per
// tile. Per query, from the caller's (bl, br, lstart, lend, rend): the left
// candidate is the masked leftmost min of x_blocks[bl, lstart..lend], the
// right one that of x_blocks[br, 0..rend], set to maxval unless br > bl; the
// left wins on equal values (lv <= rv). Returns (value, global index).
//
// Bound: per query the elements of its one or two partial ranges, 20 bytes of
// bounds and one (value, index) written: at B = 4096 with both rows whole and
// bs = 128, float32, about 4.3 MB, 1.3 us at 3.35 TB/s. A batch cannot keep
// the card's memory busy: the dependent round trips per query bound it.
//
// What held the first version back: after the bounds, the left row was read
// in 4-byte steps and reduced, and only then the right row: 3 dependent round
// trips, and a zero minimum read its row again. The design now is common.cuh's
// ``Partials``: every lane issues one 16-byte load per 128-value piece of both
// rows at once (lanes whose four values miss the range load nothing), both
// rows reduce in the same five shuffle rounds, the sign of a zero minimum
// comes from registers, and the left row wins on equal values: 2 round trips.
// One warp per query, ``tile`` warps per thread block; queries past B are
// masked; block ids are clamped to [0, nb) so a malformed bound never reads
// outside x_blocks.

#include "common.cuh"

namespace repro {

template <typename T, int C>
__global__ void rmq_partials_kernel(const T* __restrict__ xb, const int32_t* __restrict__ BL,
                                    const int32_t* __restrict__ BR,
                                    const int32_t* __restrict__ LS,
                                    const int32_t* __restrict__ LE,
                                    const int32_t* __restrict__ RE, T* __restrict__ out_val,
                                    int32_t* __restrict__ out_idx, int B, int nb, int bs_arg) {
  const int bs = C == 1 ? kPiece : bs_arg;  // a constant at bs = 128
  const int lane = threadIdx.x & 31;
  const long long q = warp_query();
  if (q >= B) return;  // whole warp leaves together
  const int bl = min(max(BL[q], 0), nb - 1);
  const int br = min(max(BR[q], 0), nb - 1);

  Partials<T, C> part;
  part.issue(xb, bl, br, LS[q], LE[q], RE[q], bs, lane);
  T v;
  int i;
  part.finish(lane, v, i);
  if (lane != 0) return;
  out_val[q] = v;
  out_idx[q] = i;
}

template <typename T>
static int launch_rmq_partials(const void* xb, const void* bl, const void* br, const void* ls,
                               const void* le, const void* re, void* out_val, void* out_idx,
                               int B, int nb, int bs, int tile, void* stream) {
  const dim3 block(32 * tile);
  const dim3 grid((B + tile - 1) / tile);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bs == kPiece) {
    rmq_partials_kernel<T, 1><<<grid, block, 0, s>>>(
        (const T*)xb, (const int32_t*)bl, (const int32_t*)br, (const int32_t*)ls,
        (const int32_t*)le, (const int32_t*)re, (T*)out_val, (int32_t*)out_idx, B, nb, bs);
  } else {
    rmq_partials_kernel<T, 2><<<grid, block, 0, s>>>(
        (const T*)xb, (const int32_t*)bl, (const int32_t*)br, (const int32_t*)ls,
        (const int32_t*)le, (const int32_t*)re, (T*)out_val, (int32_t*)out_idx, B, nb, bs);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_rmq_partials_f32(const void* xb, const void* bl, const void* br,
                                      const void* ls, const void* le, const void* re,
                                      void* out_val, void* out_idx, int B, int nb, int bs,
                                      int tile, void* stream) {
  return repro::launch_rmq_partials<float>(xb, bl, br, ls, le, re, out_val, out_idx, B, nb, bs,
                                           tile, stream);
}

extern "C" int repro_rmq_partials_i32(const void* xb, const void* bl, const void* br,
                                      const void* ls, const void* le, const void* re,
                                      void* out_val, void* out_idx, int B, int nb, int bs,
                                      int tile, void* stream) {
  return repro::launch_rmq_partials<int32_t>(xb, bl, br, ls, le, re, out_val, out_idx, B, nb, bs,
                                             tile, stream);
}
