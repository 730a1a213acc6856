"""packed_hybrid per layout and the two-pass query through the conformance scenarios.

The scenarios of ``tests/test_conformance.py`` (shared with
``tests/test_torch_conformance.py``, which runs every registry engine with
its defaults) go through the port's packed hybrid with each layout pinned —
packed64 on the plain short path, packed32 and quantized on the kernel's
(``fused_query_packed``, its plain version on the CPU), quantized also on
the plain one — and through ``ops.query(fused=False)``, beside the same
reference builds (Pallas kernels in interpret mode). packed32 on the
unpacked hybrid's defaults is covered there by ``packed_hybrid`` on int32
data. Tolerance: exact; structures equal leaf for leaf.
"""

import importlib.util
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build as jax_build_mod
from repro.core import hybrid as jax_hybrid
from repro.core import ref
from repro.core import registry as jax_registry
from repro.kernels import ops as jax_ops
from repro_torch.core import build as build_mod
from repro_torch.core import hybrid, registry
from repro_torch.kernels import ops
from torch_parity_util import assert_same_answer, assert_same_structure

_spec = importlib.util.spec_from_file_location(
    "_reference_conformance_paths", Path(__file__).with_name("test_conformance.py")
)
_conformance = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_conformance)
SCENARIOS = _conformance.SCENARIOS


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize(
    "layout,use_kernels",
    [("packed64", False), ("packed32", True), ("quantized", False), ("quantized", True)],
)
def test_packed_hybrid_layouts_match_reference(layout, use_kernels, scenario):
    """Each layout, with the plain short path and with the kernel's (its
    plain version here; the reference's Pallas kernel in interpret mode).
    packed32 must refuse data whose key span it cannot encode, as the
    reference does."""
    rng = np.random.default_rng(zlib.crc32(scenario.encode()))
    x, l, r = SCENARIOS[scenario](rng)
    kw = dict(block_size=128, packed=layout, use_kernels=use_kernels)
    try:
        js = jax_build_mod.build("hybrid", jnp.asarray(x), **kw)
    except ValueError:
        with pytest.raises(ValueError, match="packed32"):
            build_mod.build("hybrid", x, device="cpu", **kw)
        return
    ps = build_mod.build("hybrid", x, device="cpu", **kw)
    assert_same_structure(js, ps)
    want = jax_hybrid.query(js, l, r)
    got = hybrid.query(ps, l, r)
    assert_same_answer(want, got, x=x, gold=ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_two_pass_query_matches_reference(scenario):
    """``ops.query(fused=False)``: the rmq_partials kernel (plain version
    here, Pallas interpret in the reference), then interior and merge."""
    rng = np.random.default_rng(zlib.crc32(scenario.encode()))
    x, l, r = SCENARIOS[scenario](rng)
    js, _ = jax_registry.get("fused128").build(jnp.asarray(x))
    ps, _ = registry.get("fused128").build(x, device="cpu")
    want = jax_ops.query(js, jnp.asarray(l), jnp.asarray(r), fused=False, interpret=True)
    got = ops.query(ps, l, r, fused=False)
    assert_same_answer(want, got, x=x, gold=ref.rmq_ref(x, l, r))
