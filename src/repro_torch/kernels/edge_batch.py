"""A query batch that pins the fused-query kernels' load scheme.

The CUDA kernels read each partial row in 16-byte pieces (four values per
lane, 128 values per warp-wide load), reduce the two rows together and take
the sign of a zero minimum from registers. ``edge_batch`` makes the inputs
where such a scheme can go wrong, for any ``bs`` that is a multiple of 128:

* ranges that start and end at positions 4j, 4j+3 and mid-chunk (4j+1,
  4j+2), so a lane's four values are cut on either side;
* a minimum tied across the two partial rows, across neighbouring lanes'
  pieces (positions 4t+3 and 4t+4), across the 128-value pieces of one row
  and across a row end and the next row's start;
* zeros of both signs, so the sign of a zero minimum decides the bits, in
  the partials and in the interior cells (a lo cell at +0.0 beside a hi
  cell at -0.0);
* ranges whose minimum is the padding value (+inf or INT32_MAX), in the
  partials, the interior, or both;
* block minima that differ by less than a quantized bucket, so the
  quantized layout's bucket compare collides and the exact values decide.

The tests hold the port to the reference on these inputs and
``chip_smoke.py`` holds each kernel to its plain version on them.
``doubling_edges`` does the same for the doubling-table query
(``sparse_query``): the lengths where ``exact_log2`` steps.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NB", "doubling_edges", "edge_batch", "maxval_only"]

NB = 24  # blocks of the array (the last one padded)


def edge_batch(
    bs: int, dtype: str, b: int, *, finite: bool = False, small_span: bool = False, seed: int = 0
):
    """``(x, l, r)``: an array of ``NB * bs - 5`` values and ``b`` int32
    query bounds over it. ``dtype`` is "float32" or "int32". With
    ``finite`` the float array holds float32's largest finite value where it
    would hold +inf (a quantized build needs a finite value range). With
    ``small_span`` the values are those of the int32 batch capped at 8 (its
    padding blocks hold 8), as int32 or as the float32 values that many ulps
    from 1.0, with the int32 batch's bounds: a key span packed32 holds."""
    if bs % 128:
        raise ValueError(f"bs must be a multiple of 128, got {bs}")
    if small_span:
        x, l, r = edge_batch(bs, "int32", b, seed=seed)
        x = np.minimum(x, 8)
        if dtype == "float32":
            x = (x + np.int32(0x3F800000)).view(np.float32)
        return x, l, r
    rng = np.random.default_rng(seed)
    n = NB * bs - 5
    if dtype == "float32":
        big = np.finfo(np.float32).max if finite else np.inf
        x = rng.choice(np.array([1.0, 2.0, 3.0], np.float32), n)
        pos0, neg0, tie = np.float32(0.0), np.float32(-0.0), np.float32(0.5)
        near = np.array([0.75, np.nextafter(np.float32(0.75), np.float32(1)), 0.750001], np.float32)
    elif dtype == "int32":
        big = np.iinfo(np.int32).max
        x = rng.integers(1, 4, n).astype(np.int32)
        pos0 = neg0 = np.int32(0)
        tie = np.int32(-3)
        near = np.array([-1, -1, 0], np.int32)
    else:
        raise ValueError(f"dtype must be float32 or int32, got {dtype!r}")

    def at(block: int, off: int) -> int:
        return block * bs + off

    x[at(2, 0) : at(6, 0)] = big  # blocks 2-5: nothing but the padding value
    for t in range(bs // 4 - 1):  # block 7: zeros of both signs at piece edges
        if t % 3 == 0:
            x[at(7, 4 * t + 3)] = pos0
        elif t % 3 == 1:
            x[at(7, 4 * t + 4)] = neg0
    x[at(8, 4 * 2 + 3)] = pos0  # block 8: +0.0 only
    x[at(10, 4 * 3 + 3)] = pos0  # interior 10..12: lo cell +0.0, hi cell -0.0
    x[at(12, 4 * 7 + 4)] = neg0
    x[[at(14, 4 * 9 + 3), at(14, 4 * 9 + 4)]] = tie  # neighbouring lanes
    x[at(15, 4 * 2 + 3)] = tie  # the same minimum in the next row
    x[[at(16, 127), at(16, 128)]] = tie  # pieces 0|1 (bs > 128) or row 16|17
    for blk in range(18, NB - 1):  # near-equal block minima: bucket collisions
        x[at(blk, int(rng.integers(0, bs)))] = near[blk % 3]

    fixed = [
        (at(2, 3), at(5, 4)),  # padding value in both partials and the interior
        (at(9, 5), at(13, 9)),  # interior zeros of both signs
        (at(2, 0), at(2, bs - 1)),
        (at(7, 0), at(7, bs - 1)),
        (at(7, 4 * 3 + 1), at(8, 4 * 5 + 2)),
        (at(14, 4 * 9 + 3), at(14, 4 * 9 + 4)),
        (at(14, 1), at(15, 100)),
        (at(16, 120), at(17, 9)),
        (at(1, 4 * 5 + 3), at(1, 4 * 5 + 3)),
        (at(17, 0), at(NB - 1, bs - 6)),
        (0, n - 1),
    ][:b]
    m = b - len(fixed)
    edge = np.array([0, 3, 1, 2])  # 4j, 4j+3, then mid-piece
    bl = rng.integers(0, NB, m)
    br = np.minimum(bl + rng.choice([0, 1, 2, 3, 4, 7, 12, NB], m), NB - 1)
    lo = bl * bs + 4 * rng.integers(0, bs // 4, m) + rng.choice(edge, m)
    hi = br * bs + 4 * rng.integers(0, bs // 4, m) + rng.choice(edge, m)
    l = np.minimum(np.minimum(lo, hi), n - 1)
    r = np.minimum(np.maximum(lo, hi), n - 1)
    l = np.concatenate([[q[0] for q in fixed], l]).astype(np.int32)
    r = np.concatenate([[q[1] for q in fixed], r]).astype(np.int32)
    return x, l, r


def maxval_only(x: np.ndarray, l, r) -> np.ndarray:
    """Per query, whether every element of ``x[l..r]`` is the dtype's
    maximum (+inf, INT32_MAX): the ranges where a masked lane carrying that
    maximum at its own position would win the leftmost tie (ROADMAP.md §3).
    The port answers them with ``l``, as the oracle does."""
    x = np.asarray(x)
    big = np.inf if np.issubdtype(x.dtype, np.floating) else np.iinfo(x.dtype).max
    real = np.concatenate([[0], np.cumsum(x != big)])
    return real[np.asarray(r) + 1] == real[np.asarray(l)]


def doubling_edges(n: int):
    """``(l, r)`` int32 bounds over an array of ``n`` values where a
    doubling-table query can go wrong: lengths 1, ``n`` and every 2^k - 1,
    2^k and 2^k + 1 up to ``n`` (where ``exact_log2`` steps, and the two
    cells overlap least or most), each from the array's start and to its
    end, then two (0, 0) queries, the pads of ``hybrid.dispatch_by_length``."""
    steps = {(1 << k) + d for k in range(n.bit_length()) for d in (-1, 0, 1)}
    lengths = sorted(v for v in steps | {1, n} if 1 <= v <= n)
    l = [0] * len(lengths) + [n - v for v in lengths] + [0, 0]
    r = [v - 1 for v in lengths] + [n - 1] * len(lengths) + [0, 0]
    return np.array(l, np.int32), np.array(r, np.int32)
