"""repro_torch on the card: each CUDA kernel against its plain version.

Every test here needs an NVIDIA GPU and the CUDA toolkit, carries the
``cuda`` marker and skips elsewhere (the kernels have no interpret mode).
This file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: exact (indices and values equal, bit for bit).
"""

import numpy as np
import pytest
import torch

from repro_torch import update
from repro_torch._tree import leaves, tree_map
from repro_torch.core import block_rmq, hybrid, lane_rmq, ref, sparse_table
from repro_torch.kernels import ops
from repro_torch.kernels.block_min import block_min, block_min_plain
from repro_torch.kernels.edge_batch import doubling_edges, edge_batch, maxval_only
from repro_torch.kernels.fused_query import (
    fused_query,
    fused_query_packed,
    fused_query_packed_plain,
    fused_query_plain,
)
from repro_torch.kernels.lane_query import lane_partials, lane_partials_plain
from repro_torch.kernels.rmq_query import rmq_partials, rmq_partials_plain
from repro_torch.kernels.sparse_query import sparse_query, sparse_query_plain
from repro_torch.launch import serve
from torch_parity_util import assert_same_structure

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _values(rng, n, dtype):
    if dtype == "f32":
        return rng.random(n, dtype=np.float32)
    if dtype == "f32z":  # ties between -0.0 and +0.0, and negatives
        return rng.choice(np.array([-1.5, -0.0, 0.0, 0.0, 2.0], np.float32), n)
    return rng.integers(0, 3, n).astype(np.int32)  # tie-heavy


def _same_bits(got, want):
    """Output tuples equal bit for bit (so -0.0 and +0.0 differ)."""
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _queries(rng, n, b):
    a = rng.integers(0, n, b)
    c = rng.integers(0, n, b)
    l, r = np.minimum(a, c), np.maximum(a, c)
    l[:3] = [0, n // 2, n - 1]  # full range and l == r queries
    r[:3] = [n - 1, n // 2, n - 1]
    return l.astype(np.int32), r.astype(np.int32)


@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_kernels_match_plain_on_card(cuda, dtype):
    rng = np.random.default_rng(5)
    n = 300 * 128 + 11
    x = _values(rng, n, dtype)
    xb = block_rmq.pad_blocks(torch.from_numpy(x).to(cuda), 128)
    for got, want in zip(block_min(xb), block_min_plain(xb)):
        assert torch.equal(got, want)
    s = ops.build(x, 128, device=cuda)
    l, r = _queries(rng, n, 1001)
    lt, rt = torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda)
    args = (s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, lt, rt)
    outs = []
    for fetch in ("resident", "dma"):
        for tile in (1, 4, 8):
            got = fused_query(*args, st_val=s.st_val, st_gidx=s.st_gidx, fetch=fetch, tile=tile)
            want = fused_query_plain(*args, st_val=s.st_val, st_gidx=s.st_gidx, fetch=fetch)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            outs.append(got)
    gold = ref.rmq_ref(x, l, r)
    np.testing.assert_array_equal(outs[0][0].cpu().numpy(), gold)
    assert all(torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1]) for o in outs)


def test_launch_counters_count_kernel_launches_only(cuda):
    xb = torch.zeros((4, 128))
    before = (block_min.launches, fused_query.launches)
    block_min(xb)  # CPU tensor: the plain version, no count
    assert (block_min.launches, fused_query.launches) == before
    s = ops.build(np.arange(1000, dtype=np.float32), 128, device=cuda)
    idx, _ = ops.query(s, [3], [900])
    assert idx.tolist() == [3]
    assert block_min.launches == before[0] + 1 and fused_query.launches == before[1] + 1


def test_dispatch_counts_copies_and_times_each_path_on_card(cuda, monkeypatch):
    from repro_torch.obs import metrics, trace

    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_DEFAULT", reg)
    n, b = 1 << 20, 5000
    x = np.random.default_rng(4).random(n, dtype=np.float32)
    s = hybrid.build(x, device=cuda)  # threshold sqrt(n) = 1024
    rng = np.random.default_rng(5)
    length = rng.integers(1, n // 64, b)
    l = (rng.random(b) * (n - length + 1)).astype(np.int64)
    lt = torch.from_numpy(l.astype(np.int32)).to(cuda)
    rt = torch.from_numpy((l + length - 1).astype(np.int32)).to(cuda)
    n_short = int((length <= s.threshold).sum())
    assert 0 < n_short < b
    copies = lambda d: reg.counter_total("dispatch_copy_bytes_total", direction=d)
    syncs = lambda: reg.counter_total("dispatch_host_syncs_total")
    want = ref.rmq_ref(x, l, l + length - 1)
    prev = trace.set_tracer(trace.Tracer())
    try:
        idx, val = hybrid.query(s, lt, rt)
        assert np.array_equal(idx.cpu().numpy(), want)
        # Bounds on the card: only the one read back (three int64 scalars)
        # comes down; nothing goes up, no answer leaves the card.
        assert (copies("d2h"), copies("h2d"), syncs()) == (24, 0, 1)
        # int64 numpy bounds: the three numbers are read on the host, then
        # the bounds go up once, in their own width; nothing comes down, and
        # the answers stay on the card.
        idx2, val2 = hybrid.query(s, l, l + length - 1)
        assert idx2.device.type == "cuda" and val2.device.type == "cuda"
        assert (copies("d2h"), copies("h2d"), syncs()) == (24, 16 * b, 2)
        _same_bits((idx2, val2), (idx, val))
        # The launches' CUDA events are read at a later call, once complete;
        # an empty batch launches nothing and reads nothing back.
        hybrid.query(s, np.zeros(0, np.int32), np.zeros(0, np.int32))
    finally:
        trace.set_tracer(prev)
    assert reg.counter_total("dispatch_batches_total") == 3 and syncs() == 2
    times = {h.labels["path"]: h for name, h in reg.histograms() if name == "dispatch_path_device_s"}
    assert sorted(times) == ["long", "short"]
    assert all(h.count == 2 and h.sum > 0 for h in times.values())


def _uniform_lengths(gen, n, q, dev):
    """``q`` int32 bounds over ``n`` values, lengths uniform in [1, n] (the
    ``large_b22`` law), drawn on the card."""
    length = torch.randint(1, n + 1, (q,), generator=gen, device=dev, dtype=torch.int64)
    l = (torch.rand(q, generator=gen, device=dev, dtype=torch.float64) * (n - length + 1)).to(torch.int64)
    l = torch.minimum(l, n - length)
    return l.to(torch.int32), (l + length - 1).to(torch.int32)


def _with_edges(l, r, n, dev):
    el, er = doubling_edges(n)
    return (torch.cat([torch.from_numpy(el).to(dev), l]), torch.cat([torch.from_numpy(er).to(dev), r]))


@pytest.mark.parametrize("dtype", ["f32", "f32z", "i32"])
def test_sparse_query_kernel_matches_plain_on_card(cuda, dtype):
    """The doubling-table kernel against ``sparse_query_plain``, indices and
    value bits, at n = 2^20: lengths uniform in [1, n] and the edges
    (lengths 1, n and 2^k +- 1 from either end, (0, 0) pads), in a batch
    that fills no whole thread block; then ranges of maxval alone answer
    their first index."""
    n = 1 << 20
    x = torch.from_numpy(_values(np.random.default_rng(31), n, dtype)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(31)
    l, r = _with_edges(*_uniform_lengths(gen, n, 100_003, cuda), n, cuda)
    st = sparse_table.build(x)
    _same_bits(sparse_query(st.idx, x, l, r), sparse_query_plain(st.idx, x, l, r))
    big = torch.full((n,), float("inf") if x.dtype == torch.float32 else 2**31 - 1, dtype=x.dtype, device=cuda)
    big[::4096] = 0
    stb = sparse_table.build(big)
    lb = torch.arange(1, n - 4096, 4096, dtype=torch.int32, device=cuda)
    got = sparse_query(stb.idx, big, lb, lb + 4094)
    _same_bits(got, sparse_query_plain(stb.idx, big, lb, lb + 4094))
    assert torch.equal(got[0], lb)


def test_sparse_query_kernel_past_2_31_table_offsets_on_card(cuda):
    """At the benchmark cell's n = 10^8 the table has 28 levels, and k * n
    passes 2^31 - 1 from k = 22: the kernel's 64-bit offsets against the
    plain version on 2^22 lengths uniform in [1, n] and the edges."""
    n, q = 10**8, 1 << 22
    gen = torch.Generator(device=cuda).manual_seed(32)
    x = torch.rand(n, generator=gen, device=cuda)
    st = sparse_table.build(x)
    assert (st.idx.shape[0] - 1) * n > 2**31 - 1
    l, r = _with_edges(*_uniform_lengths(gen, n, q, cuda), n, cuda)
    k = torch.floor(torch.log2((r - l + 1).double()))
    assert bool((k * n > 2**31 - 1).any())
    _same_bits(sparse_query(st.idx, x, l, r), sparse_query_plain(st.idx, x, l, r))


def test_sparse_query_counts_its_launches_on_a_mixed_hybrid_batch(cuda, monkeypatch):
    """A mixed batch through ``hybrid`` launches the kernel once on its long
    path: ``sparse_query.launches`` rises by one and
    ``sparse_query_queries_total{layout=unpacked}`` by the long launch's
    length, pads included, as ``dispatch_launched_queries_total{path=long}``
    does; a call without queries launches and counts nothing."""
    from repro_torch.obs import metrics

    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_DEFAULT", reg)
    n, b = 1 << 20, 5000
    x = np.random.default_rng(33).random(n, dtype=np.float32)
    s = hybrid.build(x, device=cuda)  # threshold sqrt(n) = 1024
    gen = torch.Generator(device=cuda).manual_seed(33)
    l, r = _uniform_lengths(gen, n, b, cuda)
    n_long = int(((r - l + 1) > s.threshold).sum())
    assert 0 < n_long < b
    before = sparse_query.launches
    idx, _ = hybrid.query(s, l, r)
    assert sparse_query.launches == before + 1
    counted = reg.counter_total("sparse_query_queries_total", layout="unpacked")
    assert counted == reg.counter_total("dispatch_launched_queries_total", path="long") == 1 << (n_long - 1).bit_length()
    assert np.array_equal(idx.cpu().numpy(), ref.rmq_ref(x, l.cpu().numpy(), r.cpu().numpy()))
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    got = sparse_query(s.st.idx, s.x, empty, empty)
    assert got[0].numel() == 0 and sparse_query.launches == before + 1
    assert reg.counter_total("sparse_query_queries_total") == counted


def test_serve_cli_on_card(cuda, capsys):
    serve.main(["--engine", "hybrid", "--n", str(1 << 16), "--batch", "512", "--batches", "2"])
    serve.main(
        ["--mode", "async", "--n", str(1 << 16), "--clients", "2", "--requests", "4", "--req-batch", "64"]
    )
    out = capsys.readouterr().out
    assert "verify[64] OK" in out and "verify: 8/8 requests bit-identical" in out


@pytest.mark.parametrize("dtype", ["f32z", "i32"])
def test_packed_and_partial_kernels_match_plain_on_card(cuda, dtype):
    """fused_query_packed (packed32 both fetches, quantized), rmq_partials
    and lane_partials against their plain versions, tiles 1/4/8, bit for bit
    (signed zeros included)."""
    rng = np.random.default_rng(6)
    n = 300 * 128 + 11
    x = _values(rng, n, dtype)
    l, r = _queries(rng, n, 1001)
    lt, rt = torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda)
    gold = ref.rmq_ref(x, l, r)
    layouts = ["quantized"] + (["packed32"] if dtype == "i32" else [])
    for layout in layouts:
        s, spec = ops.build_packed(x, 128, layout=layout, device=cuda)
        want = fused_query_packed_plain(s.blocks, s.stw, lt, rt, spec=spec, bmin_val=s.bmin_val)
        np.testing.assert_array_equal(want[0].cpu().numpy(), gold)
        for fetch in ("resident", "dma"):
            for tile in (1, 4, 8):
                got = fused_query_packed(
                    s.blocks, s.stw, lt, rt, spec=spec, bmin_val=s.bmin_val, fetch=fetch, tile=tile
                )
                _same_bits(got, want)
    fs = ops.build(x, 128, device=cuda)
    bl, br = lt // 128, rt // 128
    ls, re = lt - bl * 128, rt - br * 128
    le = torch.where(bl == br, re, 127)
    want = rmq_partials_plain(fs.x_blocks, bl, br, ls, le, re)
    for tile in (1, 4, 8):
        _same_bits(rmq_partials(fs.x_blocks, bl, br, ls, le, re, tile=tile), want)
    two_pass = ops.query(fs, lt, rt, fused=False)
    _same_bits(two_pass, ops.query(fs, lt, rt))
    s = lane_rmq.build(x, device=cuda)
    planes = (s.xs, s.suff_val, s.suff_idx, s.pref_val, s.pref_idx)
    sl, sr = lt // 128, rt // 128
    args = (sl, sr, lt - sl * 128, rt - sr * 128)
    want = lane_partials_plain(*planes, *args)
    for tile in (1, 4, 8):
        _same_bits(lane_partials(*planes, *args, tile=tile), want)
    idx, val = ops.lane_query(s, lt, rt)
    np.testing.assert_array_equal(idx.cpu().numpy(), gold)
    assert torch.equal(idx, lane_rmq.query(s, lt, rt)[0])


@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_packed64_kernel_matches_plain_at_the_cell_size_on_card(cuda, dtype):
    """The packed64 body of ``fused_query_packed`` against
    ``block_rmq.query_packed``, index and value bit for bit, at the
    benchmark cell's n = 10^8 with a batch of 2^22 whose lengths follow
    ``small_b26``'s law (LogNormal(ln n^0.3, 0.3), median about 251);
    float32 uniform in [0, 1) (ties from its 2^24 grid) and int32 in
    [-1000, 1000) (ties everywhere). Each launch adds its batch to
    ``query_kernel_queries_total``; the packed64 hybrid's short path
    launches the kernel and says so in ``use_kernels``."""
    from repro_torch.core import build as build_mod
    from repro_torch.obs.metrics import default_registry

    n, q = 10**8, 1 << 22
    gen = torch.Generator(device=cuda).manual_seed(30)
    if dtype == "f32":
        x = torch.rand(n, generator=gen, device=cuda)
    else:
        x = torch.randint(-1000, 1000, (n,), generator=gen, device=cuda, dtype=torch.int32)
    z = torch.randn(q, generator=gen, device=cuda, dtype=torch.float64)
    length = torch.clamp(torch.exp(np.log(n**0.3) + 0.3 * z), 1, n).to(torch.int64)
    span = n - length + 1
    u = torch.rand(q, generator=gen, device=cuda, dtype=torch.float64)
    l = torch.minimum((u * span).to(torch.int64), span - 1)
    lt, rt = l.to(torch.int32), (l + length - 1).to(torch.int32)
    s, spec = ops.build_packed(x, 128, layout="packed64", device=cuda)
    assert spec.layout == "packed64" and s.blocks.dtype == s.stw.dtype == torch.int64
    counter = default_registry().counter("query_kernel_queries_total", kernel="fused_query_packed", layout="packed64")
    before = counter.value
    got = fused_query_packed(s.blocks, s.stw, lt, rt, spec=spec)
    assert counter.value - before == q
    want = block_rmq.query_packed(s, spec, lt, rt)
    _same_bits(got, want)
    del s, want, got

    xs = x[: 1 << 20]
    h = build_mod.build("hybrid", xs, device=cuda, packed="packed64")
    assert h.use_kernels is True and h.spec.layout == "packed64"
    keep = rt < xs.shape[0]
    launches = fused_query_packed.launches_by_body["packed64"]
    idx, val = hybrid.query(h, lt[keep], rt[keep])
    assert fused_query_packed.launches_by_body["packed64"] > launches
    _same_bits((idx, val), block_rmq.query_packed(h.blocked, h.spec, lt[keep], rt[keep]))


def test_packed_serve_cli_on_card(cuda, capsys):
    before = fused_query_packed.launches_by_body["quantized"]
    serve.main(
        ["--engine", "packed_hybrid", "--packed", "quantized", "--n", str(1 << 16),
         "--batch", "512", "--batches", "2"]
    )
    out = capsys.readouterr().out
    assert "layout quantized" in out and "verify[64] OK" in out
    assert fused_query_packed.launches_by_body["quantized"] > before


@pytest.mark.parametrize("b", [1, 4099])
@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_edge_batch_kernels_match_plain_on_card(cuda, dtype, bs, b):
    """The kernels that read rows in 16-byte pieces (fused_query both
    fetches, fused_query_packed quantized, packed32 and packed64 (against
    ``block_rmq.query_packed``) both fetches,
    rmq_partials, lane_partials) against their plain versions on
    ``edge_batch``, the inputs tests/test_torch_kernels.py holds to the
    reference, and lane_partials also on a batch whose queries all lie
    inside single lane blocks; tiles 1 and 8, bit for bit. A misaligned
    x_blocks, packed32 or packed64 blocks or lane xs raises."""
    x, l, r = edge_batch(bs, dtype, b)
    lt, rt = torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda)
    s = ops.build(x, bs, device=cuda)
    args = (s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, lt, rt)
    tables = dict(st_val=s.st_val, st_gidx=s.st_gidx)
    for fetch in ("resident", "dma"):
        want = fused_query_plain(*args, **tables, fetch=fetch)
        for tile in (1, 8):
            _same_bits(fused_query(*args, **tables, fetch=fetch, tile=tile), want)
    bl, br = lt // bs, rt // bs
    ls, re = lt - bl * bs, rt - br * bs
    pargs = (s.x_blocks, bl, br, ls, torch.where(bl == br, re, bs - 1), re)
    want = rmq_partials_plain(*pargs)
    for tile in (1, 8):
        _same_bits(rmq_partials(*pargs, tile=tile), want)
    xq = edge_batch(bs, dtype, b, finite=True)[0]
    q, spec = ops.build_packed(xq, bs, layout="quantized", device=cuda)
    want = fused_query_packed_plain(q.blocks, q.stw, lt, rt, spec=spec, bmin_val=q.bmin_val)
    for tile in (1, 8):
        got = fused_query_packed(q.blocks, q.stw, lt, rt, spec=spec, bmin_val=q.bmin_val, tile=tile)
        _same_bits(got, want)
    shifted = torch.empty(s.x_blocks.numel() + 1, dtype=s.x_blocks.dtype, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        fused_query(shifted.view(s.x_blocks.shape), *args[1:], **tables, fetch="dma")

    xp, lp, rp = edge_batch(bs, dtype, b, small_span=True)
    lpt, rpt = torch.from_numpy(lp).to(cuda), torch.from_numpy(rp).to(cuda)
    p, spec = ops.build_packed(xp, bs, layout="packed32", device=cuda)
    want = fused_query_packed_plain(p.blocks, p.stw, lpt, rpt, spec=spec)
    for fetch in ("resident", "dma"):
        for tile in (1, 8):
            got = fused_query_packed(p.blocks, p.stw, lpt, rpt, spec=spec, fetch=fetch, tile=tile)
            _same_bits(got, want)
    shifted = torch.empty(p.blocks.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        fused_query_packed(shifted.view(p.blocks.shape), p.stw, lpt, rpt, spec=spec)

    w, spec = ops.build_packed(x, bs, layout="packed64", device=cuda)
    want = block_rmq.query_packed(w, spec, lt, rt)
    for fetch in ("resident", "dma"):
        for tile in (1, 8):
            got = fused_query_packed(w.blocks, w.stw, lt, rt, spec=spec, fetch=fetch, tile=tile)
            _same_bits(got, want)
    shifted = torch.empty(w.blocks.numel() + 1, dtype=torch.int64, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        fused_query_packed(shifted.view(w.blocks.shape), w.stw, lt, rt, spec=spec)

    ls_ = lane_rmq.build(x, device=cuda)
    planes = (ls_.xs, ls_.suff_val, ls_.suff_idx, ls_.pref_val, ls_.pref_idx)
    rng = np.random.default_rng(bs + b)
    blk = torch.from_numpy(rng.integers(0, x.size // 128, b, dtype=np.int32)).to(cuda)
    lo, hi = (torch.from_numpy(rng.integers(0, 128, b, dtype=np.int32)).to(cuda) for _ in range(2))
    same_block = (blk * 128 + torch.minimum(lo, hi), blk * 128 + torch.maximum(lo, hi))
    for lq, rq in ((lt, rt), same_block):
        sl, sr = lq // 128, rq // 128
        largs = (sl, sr, lq - sl * 128, rq - sr * 128)
        want = lane_partials_plain(*planes, *largs)
        for tile in (1, 8):
            _same_bits(lane_partials(*planes, *largs, tile=tile), want)
    shifted = torch.empty(ls_.xs.numel() + 1, dtype=ls_.xs.dtype, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        lane_partials(shifted.view(ls_.xs.shape), *planes[1:], *largs)


def _oracle_on_maxval_only(idx, x, l, r, what):
    """``idx`` equals the oracle on every query of ``(l, r)`` whose range
    holds only maxval; returns how many there were."""
    torch.cuda.synchronize()
    l, r = (a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in (l, r))
    carve = maxval_only(x, l, r)
    np.testing.assert_array_equal(
        idx.cpu().numpy()[carve], ref.rmq_ref(x, l[carve], r[carve]), err_msg=what
    )
    return int(carve.sum())


@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_edge_batch_maxval_only_ranges_on_card(cuda, dtype, bs):
    """The repaired kernels (fused_query both fetches, quantized
    fused_query_packed, rmq_partials, lane_partials) answer every
    maxval-only range of ``edge_batch`` with the oracle's index, its first
    one, on the card, tiles 1 and 8 (kernel equal to plain cannot show
    this: both were wrong together). lane_partials also takes same-block
    queries inside the maxval blocks."""
    x, l, r = edge_batch(bs, dtype, 4099)
    lt, rt = torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda)
    s = ops.build(x, bs, device=cuda)
    args = (s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, lt, rt)
    seen = 0
    for tile in (1, 8):
        for fetch in ("resident", "dma"):
            idx, _ = fused_query(*args, st_val=s.st_val, st_gidx=s.st_gidx, fetch=fetch, tile=tile)
            seen += _oracle_on_maxval_only(idx, x, l, r, f"fused_query {fetch}")
        bl, br = lt // bs, rt // bs
        ls, re = lt - bl * bs, rt - br * bs
        _, idx = rmq_partials(s.x_blocks, bl, br, ls, torch.where(bl == br, re, bs - 1), re, tile=tile)
        seen += _oracle_on_maxval_only(idx, x, l, r, "rmq_partials")
        if dtype == "int32":  # finite float data holds no +inf
            q, spec = ops.build_packed(x, bs, layout="quantized", device=cuda)
            idx, _ = fused_query_packed(q.blocks, q.stw, lt, rt, spec=spec, bmin_val=q.bmin_val, tile=tile)
            seen += _oracle_on_maxval_only(idx, x, l, r, "quantized")
        ls_ = lane_rmq.build(x, device=cuda)
        planes = (ls_.xs, ls_.suff_val, ls_.suff_idx, ls_.pref_val, ls_.pref_idx)
        rng = np.random.default_rng(bs)
        blk = rng.integers(2 * bs // 128, 6 * bs // 128, 64)  # rows of the maxval blocks
        a, c = rng.integers(0, 128, 64), rng.integers(0, 128, 64)
        inside = (blk * 128 + np.minimum(a, c), blk * 128 + np.maximum(a, c))
        for lq, rq in ((l, r), inside):
            sl, sr = lq // 128, rq // 128
            largs = [torch.from_numpy(q.astype(np.int32)).to(cuda) for q in (sl, sr, lq - sl * 128, rq - sr * 128)]
            _, idx = lane_partials(*planes, *largs, tile=tile)
            seen += _oracle_on_maxval_only(idx, x, lq, rq, "lane_partials")
    assert seen > 0


@pytest.mark.parametrize("last", ["same", "straddle"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_lane_partials_same_block_warp_on_card(cuda, dtype, last):
    """The B = 33 shape of tests/test_torch_lane.py through the kernel: the
    first 32 queries each inside one lane block (the warps' ballots find
    them and read their rows at once), the 33rd in a warp of one live lane,
    inside one block or straddling; tiles 1 and 8, bit for bit against the
    plain version."""
    rng = np.random.default_rng(33)
    n = 1000
    x = rng.integers(0, 25, n).astype(dtype)  # dense ties
    if dtype == np.float32:
        x[rng.integers(0, n, n // 5)] = -0.0
        x[rng.integers(0, n, n // 5)] = 0.0
    blk = rng.integers(0, n // 128, 33)
    a, c = rng.integers(0, 128, 33), rng.integers(0, 128, 33)
    l, r = blk * 128 + np.minimum(a, c), blk * 128 + np.maximum(a, c)
    l[0], r[0] = 128, 255  # a whole block
    if last == "straddle":
        l[32], r[32] = 5, n - 1
    sl, sr = l // 128, r // 128
    assert (sl[:32] == sr[:32]).all() and (sl[32] == sr[32]) == (last == "same")
    s = lane_rmq.build(x, device=cuda)
    planes = (s.xs, s.suff_val, s.suff_idx, s.pref_val, s.pref_idx)
    args = [torch.from_numpy(q.astype(np.int32)).to(cuda) for q in (sl, sr, l - sl * 128, r - sr * 128)]
    want = lane_partials_plain(*planes, *args)
    for tile in (1, 8):
        _same_bits(lane_partials(*planes, *args, tile=tile), want)
    np.testing.assert_array_equal(want[1].cpu().numpy()[:32], ref.rmq_ref(x, l, r)[:32])


def test_online_hybrid_on_card(cuda):
    """An online hybrid on the card: a point write and an append, each
    answered as the oracle of the mutated array; a version pinned before
    them keeps answering from its own tensors (copy-on-write on the
    device); no kernel launches (the reference pins the plain short path
    online); the final state equals a from-scratch build leaf for leaf."""
    rng = np.random.default_rng(16)
    n = 5000
    x = rng.integers(0, 50, n).astype(np.float32)
    online = update.make_online("hybrid", x, device=cuda, threshold=300)
    ver0 = online.pin()
    l, r = _queries(rng, n, 300)
    launches = fused_query.launches + block_min.launches
    xm = x.copy()
    for log in (update.DeltaLog().point(1234, -1.0), update.DeltaLog().append(np.full(300, -2.0, np.float32))):
        res = online.apply(log)
        assert res.patched and res.publish_bytes > 0
        xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
        lq, rq = _queries(rng, xm.shape[0], 300)
        ver = online.pin()
        idx, val = online.query(ver.state, lq, rq)
        online.release(ver.vid)
        gold = ref.rmq_ref(xm, lq, rq)
        assert idx.device.type == cuda.type and idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.cpu().numpy(), gold)
        np.testing.assert_array_equal(val.cpu().numpy(), xm[gold])
    idx0, val0 = online.query(ver0.state, l, r)
    np.testing.assert_array_equal(idx0.cpu().numpy(), ref.rmq_ref(x, l, r))
    online.release(ver0.vid)
    assert fused_query.launches + block_min.launches == launches
    plan = update.engines.build_mod.plan_for(
        "hybrid", xm.shape[0], device=cuda, threshold=300, use_kernels=False
    )
    fresh = update.engines.build_mod.execute(plan, xm)
    got = online.store.current.state
    for a, b in ((fresh.blocked.x_blocks, got.blocked.x_blocks), (fresh.blocked.bmin_val, got.blocked.bmin_val),
                 (fresh.blocked.bmin_gidx, got.blocked.bmin_gidx), (fresh.blocked.st.idx, got.blocked.st.idx),
                 (fresh.st.idx, got.st.idx), (fresh.x, got.x)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_durable_restore_on_card(cuda, tmp_path):
    """A durable hybrid on the card at n = 2^20: create (base checkpoint),
    a write, a checkpoint, a write and an append (the journal suffix), a
    crash, then a restore onto the card: the replayed engine's leaves equal
    the live engine's bit for bit, at the same version and seq, and it
    answers the oracle."""
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.fault import DurableEngine

    rng = np.random.default_rng(17)
    n = 1 << 20
    x = rng.random(n, dtype=np.float32)
    root = str(tmp_path / "root")
    d = DurableEngine.create("hybrid", x, root, device=cuda, threshold=64)
    xm = x.copy()
    logs = (
        update.DeltaLog().point(12345, -1.0),
        update.DeltaLog().fill(1000, 1063, -0.5),
        update.DeltaLog().append(np.full(32, -2.0, np.float32)),
    )
    for i, log in enumerate(logs):
        d.apply(log)
        xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
        if i == 0:
            d.checkpoint()
    live = [(k, t.cpu()) for k, t in _flatten(d.store.current.state) if isinstance(t, torch.Tensor)]
    vid, seq = d.current_vid, d.seq
    d.close()
    del d
    r = DurableEngine.restore(root, device=cuda)
    assert (r.current_vid, r.seq, r.replayed) == (vid, seq, 2)
    got = [(k, t) for k, t in _flatten(r.store.current.state) if isinstance(t, torch.Tensor)]
    assert [k for k, _ in got] == [k for k, _ in live]
    for (k, a), (_, b) in zip(live, got):
        assert b.device.type == "cuda" and a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b.cpu()), k
    l, rq = _queries(rng, xm.shape[0], 4096)
    ver = r.pin()
    idx, val = r.query(ver.state, l, rq)
    r.release(ver.vid)
    gold = ref.rmq_ref(xm, l, rq)
    np.testing.assert_array_equal(idx.cpu().numpy(), gold)
    np.testing.assert_array_equal(val.cpu().numpy(), xm[gold])
    r.close()


@pytest.mark.parametrize("packed", [None, "packed64"])
@pytest.mark.parametrize("mode", ["shard_structure", "shard_batch", "shard_2d"])
def test_sharded_hybrid_modes_on_card(cuda, mode, packed):
    """Each mode of the sharded hybrid on a (2, 4) mesh of 8 shards on the
    card: indices equal to the single-device hybrid's (its fused kernel) and
    to the oracle, values to x[gold], answers on the card; the mesh queries
    launch no kernel (they run the plain paths, as the reference's run no
    Pallas kernel). Each structure shard has one copy on the card, shared
    by the positions that sit there."""
    from repro_torch.core import registry, sharded_hybrid
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.workload import make_queries

    rng = np.random.default_rng(18)
    n = 1 << 18
    x = rng.random(n, dtype=np.float32)
    mesh = make_mesh((2, 4), ("data", "model"), devices=[cuda])
    assert len(mesh.physical_devices) == 1 and mesh.physical_devices[0].type == "cuda"
    hyb = registry.build_for_serving("hybrid", x, device=cuda)
    s = sharded_hybrid.build(x, mesh, threshold=512, mode=mode, packed=packed)
    for leaf in (s.blocked[0], s.st[0]):
        assert leaf.num_shards == {"shard_structure": 8, "shard_batch": 1, "shard_2d": 2}[mode]
        assert all(len(copies) == 1 for copies in leaf.copies)
    for dist in ("small", "medium"):
        l, r = make_queries(rng, n, 4099, dist)
        want = hybrid.query(hyb, l, r)[0].cpu().numpy()
        launches = fused_query.launches + block_min.launches + fused_query_packed.launches
        idx, val = sharded_hybrid.query(s, l, r)
        assert fused_query.launches + block_min.launches + fused_query_packed.launches == launches
        gold = ref.rmq_ref(x, l, r)
        assert idx.device.type == "cuda" and idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.cpu().numpy(), want)
        np.testing.assert_array_equal(want, gold)
        np.testing.assert_array_equal(val.cpu().numpy(), x[gold])


def test_mesh_replicas_hold_no_extra_copy_on_card(cuda):
    """At n = 2^22 on an 8-shard mesh of one card, neither shard_batch (the
    structures replicated over 8 positions) nor shard_2d (replicated over
    the 4 batch positions) peaks above 1.1 x shard_structure's build peak:
    the positions on one card share one copy."""
    import gc

    from repro_torch.core import sharded_hybrid
    from repro_torch.launch.mesh import make_mesh

    x = np.random.default_rng(19).random(1 << 22, dtype=np.float32)
    mesh = make_mesh((2, 4), ("data", "model"), devices=[cuda])
    peaks = {}
    for mode in ("shard_structure", "shard_batch", "shard_2d"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        s = sharded_hybrid.build(x, mesh, mode=mode)
        torch.cuda.synchronize()
        peaks[mode] = torch.cuda.max_memory_allocated()
        del s
    assert peaks["shard_batch"] <= 1.1 * peaks["shard_structure"], peaks
    assert peaks["shard_2d"] <= 1.1 * peaks["shard_structure"], peaks


def test_mesh_engines_serve_cli_on_card(cuda, capsys):
    """--qshard 2d and --engine distributed on the card's default mesh."""
    serve.main(["--engine", "sharded_hybrid", "--qshard", "2d", "--mode", "async", "--n", "65536",
                "--clients", "2", "--requests", "4", "--req-batch", "64"])
    out = capsys.readouterr().out
    assert "verify: 8/8 requests bit-identical to the oracle" in out and "device(s) (cuda" in out
    serve.main(["--engine", "distributed", "--n", "65536", "--batch", "1024", "--batches", "2"])
    assert "verify[64] OK" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["shard_structure", "shard_2d"])
def test_mesh_patch_on_card(cuda, mode):
    """An online sharded hybrid on a (2, 4) mesh of the card: a tie across
    a shard boundary and a fill over three shards patch on the card (no
    kernel launched), a version pinned before them keeps its tensors, and
    the final leaves equal a from-scratch build of the mutated array."""
    from repro_torch.core import build as build_mod
    from repro_torch.launch.mesh import make_mesh

    rng = np.random.default_rng(20)
    n = 1 << 16
    x = rng.integers(0, 4, n).astype(np.float32)
    mesh = make_mesh((2, 4), ("data", "model"), devices=[cuda])
    eng = update.make_online("sharded_hybrid", x, mesh=mesh, axis_names=("data", "model"), mode=mode)
    old = eng.pin()
    before = old.state.st.idx.full().clone()
    launches = fused_query.launches + block_min.launches + fused_query_packed.launches
    xm = x.copy()
    c = n // 8
    for log in (update.DeltaLog().point(c - 1, -7.0).point(c, -7.0), update.DeltaLog().fill(c - 9, 3 * c + 9, 0.25)):
        assert eng.apply(log).patched
        xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
        l, r = _queries(rng, n, 4099)
        ver = eng.pin()
        idx, val = eng.query(ver.state, l, r)
        eng.release(ver.vid)
        gold = ref.rmq_ref(xm, l, r)
        np.testing.assert_array_equal(idx.cpu().numpy(), gold)
        np.testing.assert_array_equal(val.cpu().numpy(), xm[gold])
    assert fused_query.launches + block_min.launches + fused_query_packed.launches == launches
    assert torch.equal(old.state.st.idx.full(), before)
    eng.release(old.vid)
    st = eng.store.current.state
    plan = build_mod.plan_for("sharded_hybrid", n, mesh=mesh, axis_names=("data", "model"), block_size=128,
                              threshold=int(st.threshold), mode=mode)
    fresh = build_mod.execute(plan, xm)
    assert_same_structure((fresh.blocked, fresh.st), (st.blocked, st.st))


def test_fleet_soak_on_card(cuda):
    """A small durable fleet soak on the card: three hybrid replicas, then
    three sharded_hybrid replicas of two positions each on the one card
    (``devices=[cuda:0] * 6``): an injected mid-rollout crash and an
    external crash + restore, nothing lost, every answer the oracle's."""
    from repro_torch.serve.fleet import run_fleet_soak

    for engine, kw in (("hybrid", {}), ("sharded_hybrid", {"devices": [torch.device("cuda", 0)] * 6})):
        report = run_fleet_soak(engine=engine, replicas=3, n=1 << 12, requests=48, updates=4, seed=1, **kw)
        assert report.ok, report.summary()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b"])
def test_lm_on_card_matches_cpu(cuda, arch):
    """A reduced model on the card equals its CPU run: prefill, four decode
    steps and every cache leaf. float32, with the caller's TF32 flag on:
    the forward holds TF32 off (``layers.reference_matmul``), so the cuBLAS
    and CPU sums differ only in order: 1e-4 relative, the bound the CPU
    parity tests hold the port to against the reference."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import model

    cfg = reduce_for_smoke(get_config(arch))
    params = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    on_card = {
        k: ({n: t.to(cuda) for n, t in v.items()} if isinstance(v, dict) else v.to(cuda)) for k, v in params.items()
    }
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 44)).astype(np.int32))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        runs = []
        for p, dev in ((params, "cpu"), (on_card, cuda)):
            logits, cache = model.prefill(p, tokens[:, :40].to(dev), cfg)
            out = [logits.cpu()]
            for t in range(40, 44):
                logits, cache = model.decode_step(p, tokens[:, t : t + 1].to(dev), cache, cfg)
                out.append(logits.cpu())
            out += [getattr(cache, f).cpu() for f in ("k", "v", "conv", "ssd") if getattr(cache, f) is not None]
            runs.append(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(*runs):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max() / b.abs().max()) < 1e-4


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of reduced qwen2 (depth 1, float32, remat on) on the
    card and on the CPU from the same state: the loss within 1e-5, every
    first moment (0.1 x the clip scale x the gradient) within 1e-4 relative
    (max abs difference over the CPU's max abs value), and every updated
    master leaf within 1e-4 on the elements whose gradient is zero or at
    least 1% of its leaf's largest. AdamW's first step is about
    ``lr * g / |g|``, so an element whose gradient is near 0 carries the two
    devices' rounding into its sign: those elements must lie within 2 lr
    (the rule of tests/test_torch_train_parity.py)."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    lr = 1e-3
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-1.5b")), num_layers=1, remat=True)
    params = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    outs = []
    for dev in ("cpu", cuda):
        mesh = make_mesh((1, 1), ("data", "model"), devices=dev)
        step, _ = make_train_step(cfg, mesh, lr_fn=lambda s: torch.tensor(lr), batch=2, seq_len=64)
        p = tree_map(lambda t: t.to(dev), params)
        batch = pipeline.synthetic_batch(cfg, 2, 64, seed=0, step=0, device=dev)
        _, opt, m = step(p, adamw.init(p), batch)
        outs.append((float(m["loss"]), *(tree_map(lambda t: t.cpu(), t) for t in (opt.mu, opt.master))))
    (l_cpu, mu_cpu, w_cpu), (l_gpu, mu_gpu, w_gpu) = outs
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for m_c, m_g, w_c, w_g in zip(*(leaves(t) for t in (mu_cpu, mu_gpu, w_cpu, w_gpu))):
        scale = float(m_c.abs().max())
        assert float((m_g - m_c).abs().max()) <= 1e-4 * scale
        ratio = m_c.abs() / max(scale, 1e-30)
        fine = (ratio >= 1e-2) | (ratio == 0)
        diff = (w_g - w_c).abs()
        assert float(diff[fine].max()) <= 1e-4 * float(w_c.abs().max())
        assert float(diff.max()) <= 2 * lr


def test_run_training_on_card_survives_a_fault(cuda, tmp_path):
    """The runner on the card: a fault at step 3 restores the step-2
    checkpoint and replays; 6 steps done with one restart, and the final
    state equals an uninterrupted run's within 1e-6 relative (a backward
    pass on the card may sum scattered gradients in another order)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import runner
    from repro_torch.train.steps import make_train_step

    cfg = reduce_for_smoke(get_config("granite-3-8b"))
    mesh = make_mesh((1, 1), ("data", "model"), devices=cuda)
    step, _ = make_train_step(cfg, mesh, lr_fn=adamw.cosine_schedule(1e-3, 1, 6), batch=2, seq_len=32)
    params = model.init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    opt = adamw.init(params)
    boom = {3: True}

    def hook(s):
        if boom.pop(s, None):
            raise RuntimeError("injected fault")

    rc = runner.RunnerConfig(total_steps=6, ckpt_dir=str(tmp_path / "a"), ckpt_every=2, seed=1)
    rep = runner.run_training(step, params, opt, cfg, 2, 32, rc, fault_hook=hook)
    assert rep.restarts == 1 and rep.steps_done == 7  # steps 3.. replayed from the step-2 checkpoint
    clean = runner.run_training(
        step, params, opt, cfg, 2, 32, runner.RunnerConfig(total_steps=6, ckpt_dir=str(tmp_path / "b"), ckpt_every=2, seed=1)
    )
    for a, b in zip(leaves(rep.opt_state.master), leaves(clean.opt_state.master)):
        assert a.device.type == "cuda" and float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def _nccl_rank_steps(rank, out):
    """Two steps of reduced qwen2 (float32) on a (1, 1) mesh of one NCCL
    rank, DTensor leaves; the losses and the whole state to ``out``."""
    from repro_torch import _dtensor
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step, place_state

    cfg = reduce_for_smoke(get_config("qwen2-1.5b"))
    mesh = make_mesh((1, 1), ("data", "model"))
    step, info = make_train_step(cfg, mesh, lr_fn=adamw.cosine_schedule(1e-3, 1, 4), batch=2, seq_len=64)
    params = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params, opt = place_state(mesh, info, params, adamw.init(params))
    assert all(_dtensor.is_dtensor(t) and t.device.type == "cuda" for t in leaves((params, opt)))
    losses = []
    for i in range(2):
        params, opt, m = step(params, opt, pipeline.synthetic_batch(cfg, 2, 64, seed=0, step=i, device=mesh.rank_device))
        losses.append(float(m["loss"]))
    whole = [_dtensor.full(t).cpu().numpy() for t in leaves((opt.mu, opt.master))]
    np.savez(f"{out}/rank.npz", *whole, losses=np.array(losses))


def test_one_nccl_rank_trains_as_one_card_does(cuda, tmp_path):
    """The rank path on the card: one NCCL rank (``launch.ranks.spawn``, a
    ``file://`` rendezvous) with (1, 1) DTensor leaves, two steps of reduced
    qwen2, against the same two steps on the card without ranks. Only the
    order of some sums differs (the sharded cross entropy, DTensor's
    reductions): the losses within 1e-5, every first moment within 1e-4 of
    its leaf's largest, every master leaf within 1e-4 on the elements whose
    gradient is zero or at least 1% of its leaf's largest and within 2 x the
    summed lr elsewhere (the rules of tests/test_torch_train_parity.py;
    a gradient's share is the least over the two steps)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data import pipeline
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    ranks.spawn(_nccl_rank_steps, 1, str(tmp_path), device_type="cuda", init_method=f"file://{tmp_path}/rendezvous")
    got = np.load(tmp_path / "rank.npz")
    cfg = reduce_for_smoke(get_config("qwen2-1.5b"))
    lr_fn = adamw.cosine_schedule(1e-3, 1, 4)
    step, _ = make_train_step(cfg, make_mesh((1, 1), ("data", "model"), devices=cuda), lr_fn=lr_fn, batch=2, seq_len=64)
    params = tree_map(lambda t: t.to(cuda), model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    opt = adamw.init(params)
    losses, lrs, ratios, prev = [], [], None, None
    for i in range(2):
        params, opt, m = step(params, opt, pipeline.synthetic_batch(cfg, 2, 64, seed=0, step=i, device=cuda))
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        # each step's gradient, up to the clip scale, from the first moments: g_t ~ mu_t - b1 mu_{t-1}
        mu = [t.cpu().double().numpy() for t in leaves(opt.mu)]
        g = mu if prev is None else [a - 0.9 * b for a, b in zip(mu, prev)]
        r = [np.abs(x) / max(np.abs(x).max(), 1e-300) for x in g]
        ratios, prev = (r if ratios is None else [np.minimum(a, b) for a, b in zip(ratios, r)]), mu
    assert np.all(np.abs(got["losses"] - losses) <= 1e-5 * np.abs(losses)), (got["losses"], losses)
    mus, masters = leaves(opt.mu), leaves(opt.master)
    theirs = [got[f"arr_{i}"] for i in range(len(mus) + len(masters))]
    for m_r, w_r, m_c, w_c, ratio in zip(theirs[: len(mus)], theirs[len(mus):], mus, masters, ratios):
        m_c, w_c = m_c.cpu().numpy(), w_c.cpu().numpy()
        assert float(np.abs(m_r - m_c).max()) <= 1e-4 * float(np.abs(m_c).max())
        fine = (ratio >= 1e-2) | (ratio == 0)  # a gradient at least 1% of its leaf's largest at each step
        diff = np.abs(w_r - w_c)
        assert float(diff[fine].max(initial=0.0)) <= 1e-4 * float(np.abs(w_c).max())
        assert float(diff.max()) <= 2 * sum(lrs)
