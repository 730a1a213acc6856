// sparse_query: one launch answers a batch of doubling-table RMQs (the
// long path of the hybrid engine).
//
// Replaces no Pallas kernel: the reference's sparse table is jnp ops
// (src/repro/core/sparse_table.py ``query``). It replaces the port's chain
// of about 30 torch ops, ``core.sparse_table.query`` and the value gather
// ``x[idx]`` (kernels/sparse_query.py ``sparse_query_plain``), each a pass
// over the whole batch and a launch of its own.
//
// Per query, as the plain version computes it: len = r - l + 1 in 32-bit
// unsigned (bounds in [0, n) cannot wrap it); k = floor(log2(len)) taken
// exactly as 31 - clz, which is ``exact_log2`` for every int32 length, 2^31
// - 1 (k = 30) included; the two cells idx[k, l] and idx[k, r - 2^k + 1] at
// 64-bit offsets (k * n passes 2^31 from k = 22 at n = 10^8); their values;
// and ``_pick_left``'s choice, the lo cell when x[a] <= x[b], else the hi
// cell. The value written is the chosen cell's own load, the same compare
// on the same operands as the plain version's, so its bits (a -0.0, a NaN)
// are those of ``x[idx]``, with no fifth load.
//
// Bound: 8 B of bounds, two table cells and two values, each a random
// 32-byte sector (at n = 10^8 the table is 11.2 GB and the array 400 MB, so
// L2 holds neither), and 8 B of answers: about 144 B a query, 604 MB for a
// batch of 2^22, 0.180 ms at 3.35 TB/s.
//
// Design: random sectors bound it, so the loads of several queries are kept
// in flight at once. Each thread answers Q = ``kSparsePerThread`` queries, strided by the
// thread block so that the bounds' loads and the answers' stores stay
// coalesced, in three dependent round trips, every load of a round trip
// issued for all Q queries before any is used: the bounds; the 2Q table
// cells; the 2Q values. Every load is unconditional, from a clamped
// address: a lane past the batch reads the last query's bounds, and bounds
// outside [0, n) are clamped to it, so nothing outside the tensors is read
// (valid bounds are never changed by the clamp). No load then sits behind a
// branch that the compiler could sink to its use; only the stores are
// masked. Loads go through the read-only path (``__ldg``). The kernel's name
// holds neither ``fused_query`` nor ``block_min``: the benchmark's roofline
// readers count it with the long path, not the short one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kSparseThreads = 256;
// Queries a thread answers. 1, 2, 4 and 8 took the same time at n = 10^8,
// q = 2^22 (0.292-0.294 ms warm on an H100): the rate of random sectors
// bounds the kernel there, not the loads in flight.
constexpr int kSparsePerThread = 4;

template <typename T>
__global__ void __launch_bounds__(kSparseThreads)
    sparse_query_kernel(const int32_t* __restrict__ table, const T* __restrict__ x,
                        const int32_t* __restrict__ L, const int32_t* __restrict__ R,
                        int32_t* __restrict__ out_idx, T* __restrict__ out_val, int B, int n) {
  constexpr int Q = kSparsePerThread;
  const long long first = (long long)blockIdx.x * (kSparseThreads * Q) + threadIdx.x;

  // Round trip 1: the bounds.
  int l[Q], r[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const long long q = min(first + (long long)j * kSparseThreads, (long long)B - 1);
    l[j] = __ldg(L + q);
    r[j] = __ldg(R + q);
  }

  // Round trip 2: both cells of every query.
  int a[Q], b[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int lo = min(max(l[j], 0), n - 1);
    const int hi = min(max(r[j], lo), n - 1);
    const int k = 31 - __clz((unsigned)(hi - lo) + 1u);
    const int32_t* row = table + (long long)k * n;
    a[j] = __ldg(row + lo);
    b[j] = __ldg(row + (hi - (1 << k) + 1));
  }

  // Round trip 3: both values of every query.
  T va[Q], vb[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    va[j] = __ldg(x + a[j]);
    vb[j] = __ldg(x + b[j]);
  }

#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const long long q = first + (long long)j * kSparseThreads;
    if (q < B) {
      const bool take_a = va[j] <= vb[j];
      out_idx[q] = take_a ? a[j] : b[j];
      out_val[q] = take_a ? va[j] : vb[j];
    }
  }
}

template <typename T>
static int launch_sparse_query(const void* table, const void* x, const void* l, const void* r,
                               void* out_idx, void* out_val, int B, int n, void* stream) {
  constexpr long long per_block = (long long)kSparseThreads * kSparsePerThread;
  const dim3 grid((unsigned)((B + per_block - 1) / per_block));
  sparse_query_kernel<T><<<grid, kSparseThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const T*)x, (const int32_t*)l, (const int32_t*)r,
      (int32_t*)out_idx, (T*)out_val, B, n);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_sparse_query_f32(const void* table, const void* x, const void* l,
                                      const void* r, void* out_idx, void* out_val, int b, int n,
                                      void* stream) {
  return repro::launch_sparse_query<float>(table, x, l, r, out_idx, out_val, b, n, stream);
}

extern "C" int repro_sparse_query_i32(const void* table, const void* x, const void* l,
                                      const void* r, void* out_idx, void* out_val, int b, int n,
                                      void* stream) {
  return repro::launch_sparse_query<int32_t>(table, x, l, r, out_idx, out_val, b, n, stream);
}
