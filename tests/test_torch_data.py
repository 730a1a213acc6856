"""repro_torch.data against repro.data: the synthetic pipeline and the
RMQ-powered sequence packer.

Both pipelines draw from numpy's ``SeedSequence([seed, step])``, so their
batches are equal exactly (tokens and labels integer for integer, float32
embeddings bit for bit, bf16 embeddings rounded the same way). The packer's
assignment and free space are integers: exact. The cases of
tests/test_system.py's data tests run on the port under their names.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import packing as rpacking
from repro.data import pipeline as rpipeline
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import pack_documents, packing, pipeline
from repro_torch.models import frontends, model


@pytest.mark.parametrize("arch,dtype", [("granite-3-8b", None), ("musicgen-large", "float32"), ("internvl2-1b", "bfloat16")])
def test_synthetic_batch_equals_reference(arch, dtype):
    rcfg, pcfg = rconfigs.get_config(arch), get_config(arch)
    if dtype:
        rcfg = dataclasses.replace(rcfg, dtype=getattr(jnp, dtype))
        pcfg = dataclasses.replace(pcfg, dtype=getattr(torch, dtype))
    for step in (0, 17):
        ref = rpipeline.synthetic_batch(rcfg, 3, 24, seed=11, step=step)
        port = pipeline.synthetic_batch(pcfg, 3, 24, seed=11, step=step, device="cpu")
        assert sorted(port) == sorted(ref)
        for k, r in ref.items():
            r = np.asarray(r)
            p = port[k]
            assert str(p.dtype) == f"torch.{r.dtype}" and tuple(p.shape) == r.shape, k
            if p.dtype == torch.bfloat16:  # compare the bits
                assert np.array_equal(p.view(torch.int16).numpy(), r.view(np.int16)), k
            else:
                assert np.array_equal(p.numpy(), r), k


def test_batch_iterator_equals_reference():
    rcfg = rconfigs.reduce_for_smoke(rconfigs.get_config("qwen2-1.5b"))
    pcfg = reduce_for_smoke(get_config("qwen2-1.5b"))
    rit = rpipeline.batch_iterator(rcfg, 2, 8, seed=3, start_step=5)
    pit = pipeline.batch_iterator(pcfg, 2, 8, seed=3, start_step=5, device="cpu")
    for _ in range(3):
        r, p = next(rit), next(pit)
        assert np.array_equal(p["tokens"].numpy(), np.asarray(r["tokens"]))


@pytest.mark.parametrize("num_docs,max_len,seed", [(500, 512, 0), (20000, 2048, 7)])
def test_synthetic_documents_equal_reference(num_docs, max_len, seed):
    ref = rpipeline.synthetic_documents(num_docs, max_len, seed=seed)
    port = pipeline.synthetic_documents(num_docs, max_len, seed=seed)
    assert port.dtype == ref.dtype and np.array_equal(port, ref)


PACK_CASES = {
    # name: (num_docs, seq_len, seed, kwargs)
    "default": (500, 512, 0, {}),
    "bs256_rebuild32": (700, 512, 1, dict(block_size=256, rebuild_every=32)),
    "bins_double": (300, 256, 2, dict(num_bins=3)),  # forces the doubling path
    "truncate_long_docs": (200, 100, 3, dict(rebuild_every=1)),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_documents_equals_reference(case):
    num_docs, seq_len, seed, kw = PACK_CASES[case]
    lengths = rpipeline.synthetic_documents(num_docs, 512, seed=seed)
    r_assign, r_free = rpacking.pack_documents(lengths, seq_len, **kw)
    p_assign, p_free = packing.pack_documents(lengths, seq_len, **kw, device="cpu")
    assert p_assign.dtype == r_assign.dtype and np.array_equal(p_assign, r_assign)
    assert p_free.dtype == r_free.dtype and np.array_equal(p_free, r_free)


def test_data_pipeline_deterministic_replay():
    cfg = reduce_for_smoke(get_config("granite-3-8b"))
    b1 = pipeline.synthetic_batch(cfg, 4, 32, seed=11, step=17, device="cpu")
    b2 = pipeline.synthetic_batch(cfg, 4, 32, seed=11, step=17, device="cpu")
    b3 = pipeline.synthetic_batch(cfg, 4, 32, seed=11, step=18, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])


def test_packing_uses_rmq_and_fits():
    lengths = pipeline.synthetic_documents(500, 512, seed=0)
    assign, free = pack_documents(lengths, 512, device="cpu")
    assert (assign >= 0).all()
    # capacity never exceeded
    used = np.zeros(free.shape[0], np.int64)
    for d, b in enumerate(assign):
        used[b] += min(lengths[d], 512)
    assert (used <= 512).all()
    assert np.array_equal(used, 512 - free)
    # packing efficiency sane vs naive one-doc-per-bin
    assert (used > 0).sum() < len(lengths)


ENTRY_POINTS = {
    "pack_documents": lambda cfg: pack_documents(np.array([3, 4]), 8),
    "synthetic_batch": lambda cfg: pipeline.synthetic_batch(cfg, 1, 4, seed=0, step=0),
    "init_params": lambda cfg: model.init_params(cfg),
    "init_cache": lambda cfg: model.init_cache(cfg, 1, 4),
    "synthetic_embeddings": lambda cfg: frontends.synthetic_embeddings(cfg, 1, 4),
    "model_params": lambda cfg: convert.model_params({"w": np.ones(2, np.float32)}),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_need_a_device(entry):
    """No CUDA here: the default device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[entry](reduce_for_smoke(get_config("qwen2-1.5b")))
