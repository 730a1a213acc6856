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

from repro_torch.core import block_rmq, ref
from repro_torch.kernels import ops
from repro_torch.kernels.block_min import block_min, block_min_plain
from repro_torch.kernels.fused_query import fused_query, fused_query_plain
from repro_torch.launch import serve

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _values(rng, n, dtype):
    if dtype == "f32":
        return rng.random(n, dtype=np.float32)
    return rng.integers(0, 3, n).astype(np.int32)  # tie-heavy


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


def test_serve_cli_on_card(cuda, capsys):
    serve.main(["--engine", "hybrid", "--n", str(1 << 16), "--batch", "512", "--batches", "2"])
    serve.main(
        ["--mode", "async", "--n", str(1 << 16), "--clients", "2", "--requests", "4", "--req-batch", "64"]
    )
    out = capsys.readouterr().out
    assert "verify[64] OK" in out and "verify: 8/8 requests bit-identical" in out
