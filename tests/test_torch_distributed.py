"""repro_torch's mesh engines against the reference's 8-device programs.

The reference runs its distributed engines on 8 fake XLA devices in a
subprocess (``tests/test_distributed.py``). Here one module-scoped child
does the same once and writes its results to an ``.npz``: the sharded
leaves (``build_sharded``, ``build_sharded_st``) on a ``(8,)`` and a
``(2, 4)`` mesh for n in 512, 5000, 1057, 17, 8, 1; a mixed short/long
batch through ``distributed`` and ``sharded_hybrid`` in its three modes
(unpacked and packed); the cross-shard ties, the boundary-straddling tie,
the signed-zero merges and the maxval-only ranges; the online patch
sequence of ``tests/test_update.py``'s 8-device child for ``distributed``,
each ``sharded_hybrid`` mode and packed32, its leaves after every log; and
a durable mesh root (``tests/test_fault.py``'s 8-device timeline). The
port builds and patches the same on CPU meshes of the same shapes (8 shards
on the CPU, one process) and equals it leaf for leaf (dtypes included) and
answer for answer; the same leaves through ``convert`` answer as the
reference does, and the durable roots match byte for byte and restore
across packages. The five RMQ
children of ``tests/test_distributed.py`` and the allocation probes of
``tests/test_build_plan.py`` run here in-process. Tolerance: exact (values
compared bit for bit).

Two deliberate divergences are pinned: on a range holding only maxval the
port answers its first index where the reference's blocked paths answer
index 0 (ROADMAP.md §3); and the reference's batch-sharded queries return
+0.0 for a -0.0 answer when the batch is not a multiple of the shard count,
where the port returns the element's bits.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fault as jax_fault
from repro.core import ref
from repro_torch import convert, update
from repro_torch.core import block_rmq, distributed, hybrid, sharded_hybrid, sparse_table
from repro_torch.core import build as build_mod
from repro_torch.fault import DurableEngine
from repro_torch.launch.mesh import make_mesh
from torch_parity_util import leaves, to_np

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"8": ((8,), ("shard",)), "2x4": ((2, 4), ("data", "model"))}
HALO_NS = (512, 5000, 1057, 17, 8, 1)
MIX = [("2x4", mode, packed) for mode in sharded_hybrid.MODES for packed in (None, "packed32")] + [
    ("8", mode, "packed64") for mode in sharded_hybrid.MODES
]

_CHILD = textwrap.dedent(
    """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.core import distributed, sharded_hybrid
    from repro.launch.mesh import make_mesh

    assert len(jax.devices()) == 8
    out = {}
    meshes = {"8": (make_mesh((8,), ("shard",)), ("shard",)),
              "2x4": (make_mesh((2, 4), ("data", "model")), ("data", "model"))}

    def put(key, a):
        out[key] = np.array(a)  # a copy: a CPU array may share its buffer

    # The sharded leaves at the halo child's sizes (dense ties).
    for tag, (mesh, axes) in meshes.items():
        rng = np.random.default_rng(3)
        for n in (512, 5000, 1057, 17, 8, 1):
            x = rng.integers(0, 4, max(n, 1)).astype(np.float32)
            put(f"{tag}/{n}/x", x)
            t = distributed.build_sharded_st(jnp.asarray(x), mesh, axes)
            put(f"{tag}/{n}/st.idx", t.idx)
            put(f"{tag}/{n}/st.val", t.val)
            s = distributed.build_sharded(jnp.asarray(x), mesh, axes, 128)
            for f in ("x_blocks", "bmin_val", "bmin_gidx"):
                put(f"{tag}/{n}/blocked.{f}", getattr(s, f))
            put(f"{tag}/{n}/blocked.st.idx", s.st.idx)
            put(f"{tag}/{n}/blocked.st.x", s.st.x)

    # A mixed short/long batch (threshold 64) through the engines.
    for tag, (mesh, axes) in meshes.items():
        rng = np.random.default_rng(2)
        n, thr = 5000, 64
        xf = rng.integers(0, 9, n).astype(np.float32)
        xi = rng.integers(-1000, 1000, n).astype(np.int32)
        length = np.concatenate([rng.integers(1, thr + 1, 150), rng.integers(thr + 1, n + 1, 150)])
        rng.shuffle(length)
        l = rng.integers(0, np.maximum(n - length + 1, 1), 300)
        r = np.minimum(l + length - 1, n - 1)
        for k, a in (("xf", xf), ("xi", xi), ("l", l), ("r", r)):
            put(f"{tag}/mix/{k}", a)
        s = distributed.build_sharded(jnp.asarray(xf), mesh, axes, 128)
        gi, gv = distributed.make_query_fn(mesh, axes)(s, jnp.asarray(l), jnp.asarray(r))
        put(f"{tag}/mix/distributed.idx", gi)
        put(f"{tag}/mix/distributed.val", gv)
        runs = ((None, xf), ("packed32", xi)) if tag == "2x4" else (("packed64", xf),)
        for mode in sharded_hybrid.MODES:
            for packed, x in runs:
                h = sharded_hybrid.build(jnp.asarray(x), mesh, axes, 128, threshold=thr,
                                         mode=mode, packed=packed)
                hi, hv = sharded_hybrid.query(h, l, r)
                key = f"{tag}/mix/{mode}/{packed}"
                put(key + ".idx", hi)
                put(key + ".val", hv)
                arrays = [a for a in jax.tree_util.tree_leaves((h.blocked, h.st))
                          if isinstance(a, jax.Array)]
                for j, a in enumerate(arrays):
                    put(f"{key}.leaf{j}", a)

    mesh, axes = meshes["8"]
    # Tied global minima in shards 2 and 5.
    n = 8 * 256
    p1, p2 = 2 * 256 + 17, 5 * 256 + 100
    x = np.ones(n, np.float32)
    x[p1] = x[p2] = -3.0
    l = np.array([0, p1, p1 + 1, p2 + 1]); r = np.array([n - 1, p2, p2, n - 1])
    s = distributed.build_sharded(jnp.asarray(x), mesh, axes, 128)
    gi, gv = distributed.make_query_fn(mesh, axes)(s, jnp.asarray(l), jnp.asarray(r))
    t = distributed.build_sharded_st(jnp.asarray(x), mesh, axes)
    si, sv = distributed.make_st_query_fn(mesh, axes)(t, jnp.asarray(l), jnp.asarray(r))
    for k, a in (("blocked.idx", gi), ("blocked.val", gv), ("st.idx", si), ("st.val", sv)):
        put(f"tie/{k}", a)

    # A tie straddling the boundary of shards 2 and 3.
    m = 8 * 32
    x = np.ones(m, np.float32)
    x[3 * 32 - 1] = x[3 * 32] = -7.0
    t = distributed.build_sharded_st(jnp.asarray(x), mesh, axes)
    si, _ = distributed.make_st_query_fn(mesh, axes)(
        t, jnp.asarray(np.array([0, 96])), jnp.asarray(np.array([m - 1, m - 1])))
    put("straddle/st.idx", t.idx)
    put("straddle/idx", si)

    # +0.0 and -0.0 as the tied minima of two shards, both orders, at a
    # batch that divides by the 8 shards and one that does not.
    for order, (a, b) in (("pn", (0.0, -0.0)), ("np", (-0.0, 0.0))):
        x = np.ones(n, np.float32)
        x[p1], x[p2] = a, b
        engines = {"distributed": distributed.build_sharded(jnp.asarray(x), mesh, axes, 128)}
        for mode in ("shard_structure", "shard_batch"):
            for thr in (0, n):
                engines[f"{mode}/{thr}"] = sharded_hybrid.build(
                    jnp.asarray(x), mesh, axes, 128, threshold=thr, mode=mode)
        qfn = distributed.make_query_fn(mesh, axes)
        for bsz in (3, 8):
            l = np.resize(np.array([0, p1, p1 + 1]), bsz)
            r = np.resize(np.array([n - 1, p2, p2]), bsz)
            for name, h in engines.items():
                if name == "distributed":
                    gi, gv = qfn(h, jnp.asarray(l), jnp.asarray(r))
                else:
                    gi, gv = sharded_hybrid.query(h, l, r)
                put(f"zero/{order}/{bsz}/{name}.idx", gi)
                put(f"zero/{order}/{bsz}/{name}.val", gv)

    # Ranges holding only maxval, on the (2, 4) mesh.
    mesh, axes = meshes["2x4"]
    L = np.array([1, 2, 1]); R = np.array([2, 2, 1])
    for dtype, x in (("float32", np.array([0.0, np.inf, np.inf], np.float32)),
                     ("int32", np.array([5, 2**31 - 1, 2**31 - 1], np.int32))):
        s = distributed.build_sharded(jnp.asarray(x), mesh, axes, 128)
        put(f"maxval/{dtype}/distributed",
            distributed.make_query_fn(mesh, axes)(s, jnp.asarray(L), jnp.asarray(R))[0])
        for mode in sharded_hybrid.MODES:
            runs = ((10, None), (10, "auto")) + (((0, None),) if mode == "shard_structure" else ())
            for thr, packed in runs:
                h = sharded_hybrid.build(jnp.asarray(x), mesh, axes, 128, threshold=thr,
                                         mode=mode, packed=packed)
                put(f"maxval/{dtype}/{mode}/{thr}/{packed}", sharded_hybrid.query(h, L, R)[0])
    # The online patch sequence of tests/test_update.py's 8-device child, the
    # patched leaves after every log: on (8,), and shard_2d on (2, 4) too
    # (the other runs split the structure 8 ways on either mesh, and so
    # have the same global leaves).
    from repro import update
    from repro.fault import DurableEngine
    from repro.update.deltas import DeltaLog

    def logs(t50, t9000):
        return [
            DeltaLog().point(1023, -7.0).point(1024, -7.0),  # tie across a shard boundary
            DeltaLog().fill(500, 1600, 0.25),  # a range over three shards
            DeltaLog().append(t50),  # inside the blocked capacity
            DeltaLog().append(t9000),  # past every capacity: a rebuild
        ]

    runs = {"distributed": ("distributed", {}, np.float32),
            "shard_structure": ("sharded_hybrid", {"mode": "shard_structure"}, np.float32),
            "shard_batch": ("sharded_hybrid", {"mode": "shard_batch"}, np.float32),
            "shard_2d": ("sharded_hybrid", {"mode": "shard_2d"}, np.float32),
            "packed32": ("packed_sharded_hybrid", {"packed": "packed32"}, np.int32)}
    for tag, (mesh, axes) in meshes.items():
        for run, (name, kw, dt) in runs.items():
            if tag == "2x4" and run != "shard_2d":
                continue
            rng = np.random.default_rng(7)
            x = rng.integers(0, 4, 4096).astype(dt)
            t50, t9000 = (rng.integers(0, 4, k).astype(dt) for k in (50, 9000))
            for k, a in (("x", x), ("t50", t50), ("t9000", t9000)):
                put(f"{tag}/patch/{run}/{k}", a)
            eng = update.make_online(name, jnp.asarray(x), mesh=mesh, axis_names=axes, **kw)
            for i, log in enumerate(logs(t50, t9000)):
                put(f"{tag}/patch/{run}/{i}.patched", np.array(eng.apply(log).patched))
                state = eng.store.current.state
                tree = state[0] if name == "distributed" else (state.blocked, state.st)
                arrays = [a for a in jax.tree_util.tree_leaves(tree) if isinstance(a, jax.Array)]
                for j, a in enumerate(arrays):
                    put(f"{tag}/patch/{run}/{i}.leaf{j}", a)

    # A durable mesh root (tests/test_fault.py's 8-device child): three logs,
    # a checkpoint after the first.
    mesh, axes = meshes["8"]
    x = out["8/patch/shard_structure/x"]
    root = sys.argv[1] + ".durable"
    d = DurableEngine.create("sharded_hybrid", jnp.asarray(x), root, mesh=mesh, axis_names=axes,
                             mode="shard_structure")
    tails = (out["8/patch/shard_structure/t50"], out["8/patch/shard_structure/t9000"])
    for i, log in enumerate(logs(*tails)[:3]):
        d.apply(log)
        if i == 0:
            d.checkpoint()
    put("durable/live", np.array([d.current_vid, d.seq]))
    d.close()
    np.savez(sys.argv[1], **out)
    print("REFERENCE_CHILD_OK")
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference child's results (one subprocess, 8 fake XLA devices);
    ``"durable/root"`` names the durable root it wrote."""
    path = tmp_path_factory.mktemp("reference") / "mesh.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = "src"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(path)], env=env, capture_output=True, text=True, cwd=ROOT, timeout=420
    )
    assert "REFERENCE_CHILD_OK" in out.stdout, out.stderr[-3000:]
    with np.load(path) as z:
        res = {k: z[k] for k in z.files}
    res["durable/root"] = str(path) + ".durable"
    return res


def _mesh(tag):
    shape, axes = MESHES[tag]
    return make_mesh(shape, axes, devices="cpu"), axes


def _bits(a):
    a = to_np(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(want, got):
    """Equal bit for bit, dtypes included."""
    want, got = np.asarray(want), to_np(got)
    assert want.dtype == got.dtype, (want.dtype, got.dtype)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(_bits(want), _bits(got))


# --- the five RMQ children of tests/test_distributed.py, in-process ---------


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_distributed_rmq_8_shards(tag):
    mesh, axes = _mesh(tag)
    rng = np.random.default_rng(1)
    n = 5000
    x = rng.integers(0, 50, n).astype(np.float32)
    l = rng.integers(0, n, 300)
    r = rng.integers(0, n, 300)
    l, r = np.minimum(l, r), np.maximum(l, r)
    gold = ref.rmq_ref(x, l, r)
    s = distributed.build_sharded(torch.as_tensor(x), mesh, axes, 128)
    gi, gv = distributed.make_query_fn(mesh, axes)(s, l, r)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(to_np(gi), gold)
    np.testing.assert_array_equal(to_np(gv), x[gold])


def test_distributed_leftmost_tie_across_shards(reference):
    """Global min duplicated in shards 2 and 5: the merge returns the leftmost
    global index (blocked and sparse-table paths alike), as the reference."""
    mesh, axes = _mesh("8")
    n = 8 * 256
    x = np.ones(n, np.float32)
    p1, p2 = 2 * 256 + 17, 5 * 256 + 100
    x[p1] = x[p2] = -3.0
    l = np.array([0, p1, p1 + 1, p2 + 1])
    r = np.array([n - 1, p2, p2, n - 1])
    s = distributed.build_sharded(torch.as_tensor(x), mesh, axes, 128)
    gi, gv = distributed.make_query_fn(mesh, axes)(s, l, r)
    assert to_np(gi).tolist() == [p1, p1, p2, p2 + 1]
    assert to_np(gv).tolist() == [-3.0, -3.0, -3.0, 1.0]
    t = distributed.build_sharded_st(x, mesh, axes)
    si, sv = distributed.make_st_query_fn(mesh, axes)(t, l, r)
    for key, got in (("blocked.idx", gi), ("blocked.val", gv), ("st.idx", si), ("st.val", sv)):
        _same(reference[f"tie/{key}"], got)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_sharded_hybrid_bit_identical_on_8_device_mesh(tag):
    """A mixed small/large batch through every mode (the 2D structure x batch
    mesh too; 300 % 8 != 0: the pad path) equals the single-host blocked
    query bit for bit."""
    mesh, axes = _mesh(tag)
    rng = np.random.default_rng(2)
    n = 5000
    x = rng.integers(0, 9, n).astype(np.float32)
    thr = 64
    length = np.concatenate([rng.integers(1, thr + 1, 150), rng.integers(thr + 1, n + 1, 150)])
    rng.shuffle(length)
    l = rng.integers(0, np.maximum(n - length + 1, 1), 300)
    r = np.minimum(l + length - 1, n - 1)
    bi, bv = block_rmq.query(block_rmq.build(x, 128, device="cpu"), l, r)
    for mode in sharded_hybrid.MODES:
        s = sharded_hybrid.build(x, mesh, axes, 128, threshold=thr, mode=mode)
        hi, hv = sharded_hybrid.query(s, l, r)
        _same(bi, hi)
        _same(bv, hv)


def _replicated_reference(x, num):
    """The full doubling table over the shard-padded array, and its values."""
    n = x.shape[0]
    n_pad = -(-n // num) * num
    xp = np.concatenate([x, np.full(n_pad - n, block_rmq.maxval(torch.float32), np.float32)])
    st = sparse_table.build(torch.as_tensor(xp))
    return to_np(st.idx), xp[to_np(st.idx)]


def _shard_sizes(obj):
    """The element count of every per-shard tensor in a build-state value."""
    if isinstance(obj, distributed.ShardedLeaf):
        return [p.numel() for c in obj.copies for p in c.values()]
    if isinstance(obj, torch.Tensor):
        return [obj.numel()]
    if isinstance(obj, (tuple, list)):
        return [size for o in obj for size in _shard_sizes(o)]
    return []


def test_distributed_st_build_halo_exchange_8_shards(reference):
    """The distributed doubling-table build: equal to the replicated build on
    non-power-of-two n, boundary-straddling leftmost ties, levels whose 2^k
    span crosses several shards, and the per-shard allocation probe."""
    for tag in sorted(MESHES):
        mesh, axes = _mesh(tag)
        num = distributed.num_shards(mesh, axes)
        rng = np.random.default_rng(3)
        for n in HALO_NS:
            x = rng.integers(0, 4, max(n, 1)).astype(np.float32)
            t = distributed.build_sharded_st(x, mesh, axes)
            gi, gv = _replicated_reference(x, num)
            _same(gi, t.idx.full())
            _same(gv, t.val.full())

    mesh, axes = _mesh("8")
    n = 8 * 32
    x = np.ones(n, np.float32)
    x[3 * 32 - 1] = x[3 * 32] = -7.0
    t = distributed.build_sharded_st(x, mesh, axes)
    _same(_replicated_reference(x, 8)[0], t.idx.full())
    _same(reference["straddle/st.idx"], t.idx)
    si, _ = distributed.make_st_query_fn(mesh, axes)(t, np.array([0, 96]), np.array([n - 1, n - 1]))
    assert to_np(si).tolist() == [3 * 32 - 1, 3 * 32]  # the left copy, then the right
    _same(reference["straddle/idx"], si)

    n = 4096
    plan = build_mod.plan_for("sharded_st", n, mesh=mesh, axis_names=axes)
    layout = plan.layout
    k_levels = distributed.st_levels(layout.n_pad)
    budget = (k_levels + 2) * layout.shard_len
    assert budget < k_levels * layout.n_pad  # the probe is not vacuous on 8 shards
    seen = []

    def probe(stage, state):
        seen.append(stage)
        for key, value in state.items():
            if key != "x":  # the caller's input, not a build allocation
                assert all(size <= budget for size in _shard_sizes(value)), (stage, key)

    t = build_mod.execute(plan, np.random.default_rng(3).random(n, dtype=np.float32), observer=probe)
    assert seen == ["shard_layout", "local_build", "halo_exchange", "finalize"]
    for s in range(8):
        assert tuple(t.idx.part(s).shape) == (k_levels, layout.shard_len)


def test_sharded_calibration_times_sharded_constituents(monkeypatch):
    """calibrate(mesh=...) builds and times the sharded constituents on a
    2x4 mesh (deterministic through the _measure seam)."""
    mesh, axes = _mesh("2x4")
    measured = []

    def fake_measure(kind, fn, lj, rj, repeats):
        measured.append(kind)
        return 0.0 if kind == "short" else 1.0

    monkeypatch.setattr(hybrid, "_measure", fake_measure)
    for mode in ("shard_structure", "shard_2d"):
        thr = hybrid.calibrate(256, batch=8, repeats=1, mesh=mesh, axis_names=axes, mode=mode)
        assert thr == 256, (mode, thr)  # short always wins -> threshold n
    assert "short" in measured and "long" in measured


# --- the allocation probes of tests/test_build_plan.py ----------------------


def test_sharded_st_never_calls_replicated_build(monkeypatch):
    """The distributed build never falls back to ``sparse_table.build`` on
    the full array."""

    def boom(x):
        raise AssertionError(f"sparse_table.build called on shape {tuple(x.shape)} during distributed build")

    monkeypatch.setattr(sparse_table, "build", boom)
    monkeypatch.setattr(distributed.sparse_table, "build", boom)
    x = np.random.default_rng(1).random(256, dtype=np.float32)
    mesh, axes = build_mod.default_mesh("cpu")
    t = distributed.build_sharded_st(x, mesh, axes)
    assert t.idx.shape[1] == 256
    mesh, axes = _mesh("2x4")
    assert distributed.build_sharded_st(x, mesh, axes).idx.shape[1] == 256


def test_sharded_st_per_device_allocation_bounded():
    """At every stage of the distributed ST build on the default mesh, every
    per-shard tensor of the build state stays within the per-shard budget."""
    n = 1024
    plan = build_mod.plan_for("sharded_st", n, device="cpu")
    layout = plan.layout
    k_levels = distributed.st_levels(layout.n_pad)
    budget = (k_levels + 2) * layout.shard_len  # rows per shard + the level-0 pair

    def probe(stage, state):
        for key, value in state.items():
            if key != "x":
                assert all(size <= budget for size in _shard_sizes(value)), (stage, key)

    t = build_mod.execute(plan, np.arange(float(n), dtype=np.float32), observer=probe)
    assert tuple(t.idx.part(0).shape) == (k_levels, layout.shard_len)


# --- against the reference's 8-device child ----------------------------------


@pytest.mark.parametrize("n", HALO_NS)
@pytest.mark.parametrize("tag", sorted(MESHES))
def test_sharded_leaves_match_reference(reference, tag, n):
    mesh, axes = _mesh(tag)
    x = reference[f"{tag}/{n}/x"]
    t = distributed.build_sharded_st(x, mesh, axes)
    _same(reference[f"{tag}/{n}/st.idx"], t.idx)
    _same(reference[f"{tag}/{n}/st.val"], t.val)
    s = distributed.build_sharded(x, mesh, axes, 128)
    for path, leaf in leaves(s, "blocked"):
        _same(reference[f"{tag}/{n}/{path}"], leaf)
    # The same leaves through convert answer as the port's own build.
    rng = np.random.default_rng(n)
    l = rng.integers(0, x.size, 64)
    r = np.maximum(l, rng.integers(0, x.size, 64))
    gold = ref.rmq_ref(x, l, r)
    arrays = [reference[f"{tag}/{n}/{path}"] for path, _ in leaves(s, "blocked")]
    blocked, qfn = convert.distributed(_with_leaves(s, arrays), mesh, axes)
    idx, val = qfn(blocked, l, r)
    np.testing.assert_array_equal(to_np(idx), gold)
    st = convert.sharded_st(distributed.ShardedSparseTable(reference[f"{tag}/{n}/st.idx"], reference[f"{tag}/{n}/st.val"]), mesh, axes)
    si, sv = distributed.make_st_query_fn(mesh, axes)(st, l, r)
    np.testing.assert_array_equal(to_np(si), gold)
    _same(x[gold], sv)


def _with_leaves(structure, arrays):
    """``structure`` with its array leaves replaced, in order, by ``arrays``
    (the reference's global numpy leaves)."""
    it = iter(arrays)

    def sub(s):
        if s is None:
            return None
        if isinstance(s, tuple) and hasattr(s, "_fields"):
            return type(s)(*map(sub, s))
        return next(it)

    out = sub(structure)
    assert next(it, None) is None
    return out


@pytest.mark.parametrize("tag,mode,packed", MIX)
def test_mixed_batch_matches_reference(reference, tag, mode, packed):
    """Answers and leaves of every mode equal the reference's on its 8
    devices, and the reference's leaves converted onto the port's mesh
    answer the same."""
    mesh, axes = _mesh(tag)
    key = f"{tag}/mix"
    x = reference[f"{key}/xi"] if packed == "packed32" else reference[f"{key}/xf"]
    l, r = reference[f"{key}/l"], reference[f"{key}/r"]
    gold = ref.rmq_ref(x, l, r)
    h = sharded_hybrid.build(x, mesh, axes, 128, threshold=64, mode=mode, packed=packed)
    hi, hv = sharded_hybrid.query(h, l, r)
    _same(reference[f"{key}/{mode}/{packed}.idx"], hi)
    _same(reference[f"{key}/{mode}/{packed}.val"], hv)
    np.testing.assert_array_equal(to_np(hi), gold)
    got = leaves((h.blocked, h.st))
    want = [reference[f"{key}/{mode}/{packed}.leaf{j}"] for j in range(len(got))]
    assert f"{key}/{mode}/{packed}.leaf{len(got)}" not in reference  # as many leaves
    for w, (_, g) in zip(want, got):
        _same(w, g)
    nb = len(leaves(h.blocked))
    conv = convert.sharded_hybrid(
        h._replace(blocked=_with_leaves(h.blocked, want[:nb]), st=_with_leaves(h.st, want[nb:]), dtype=x.dtype),
        mesh,
        axes,
        spec=h.spec,
    )
    ci, cv = sharded_hybrid.query(conv, l, r)
    _same(hi, ci)
    _same(hv, cv)
    if tag == "2x4" and packed is None and mode == "shard_structure":
        di, dv = distributed.make_query_fn(mesh, axes)(distributed.build_sharded(x, mesh, axes, 128), l, r)
        _same(reference[f"{key}/distributed.idx"], di)
        _same(reference[f"{key}/distributed.val"], dv)


ZERO_ENGINES = ["distributed"] + [f"{m}/{t}" for m in ("shard_structure", "shard_batch") for t in (0, 8 * 256)]


@pytest.mark.parametrize("bsz", [3, 8])
@pytest.mark.parametrize("order", ["pn", "np"])
@pytest.mark.parametrize("engine", ZERO_ENGINES)
def test_signed_zero_merge_matches_reference(reference, engine, order, bsz):
    """+0.0 and -0.0 tie as the minima of shards 2 and 5. The cross-shard
    merge keeps the first shard's zero, as XLA's min does, which is the bits
    of the answer's element. The reference's batch-sharded path turns every
    zero into +0.0 when the batch does not divide by the shards; the port
    keeps the element's bits there too."""
    mesh, axes = _mesh("8")
    n = 8 * 256
    p1, p2 = 2 * 256 + 17, 5 * 256 + 100
    x = np.ones(n, np.float32)
    x[p1], x[p2] = (0.0, -0.0) if order == "pn" else (-0.0, 0.0)
    l = np.resize(np.array([0, p1, p1 + 1]), bsz)
    r = np.resize(np.array([n - 1, p2, p2]), bsz)
    if engine == "distributed":
        gi, gv = distributed.make_query_fn(mesh, axes)(distributed.build_sharded(x, mesh, axes, 128), l, r)
    else:
        mode, thr = engine.split("/")
        gi, gv = sharded_hybrid.query(sharded_hybrid.build(x, mesh, axes, 128, threshold=int(thr), mode=mode), l, r)
    key = f"zero/{order}/{bsz}/{engine}"
    _same(reference[key + ".idx"], gi)
    _same(x[to_np(gi)], gv)  # the element's bits
    want = reference[key + ".val"]
    if engine.startswith("shard_batch") and bsz % 8:
        assert (_bits(want) == 0).all()  # the reference's +0.0: fails if it changes
        np.testing.assert_array_equal(want, to_np(gv))  # equal as values
    else:
        _same(want, gv)


MAXVAL = {
    "float32": np.array([0.0, np.inf, np.inf], np.float32),
    "int32": np.array([5, 2**31 - 1, 2**31 - 1], np.int32),
}
MAXVAL_RUNS = ["distributed"] + [
    f"{m}/{t}/{p}" for m in sharded_hybrid.MODES for t, p in ((10, None), (10, "auto"))
] + ["shard_structure/0/None"]


@pytest.mark.parametrize("run", MAXVAL_RUNS)
@pytest.mark.parametrize("dtype", sorted(MAXVAL))
def test_maxval_only_ranges_on_mesh(reference, dtype, run):
    """A range holding only maxval answers its first index on every mesh
    engine of the port. The reference's blocked paths (``distributed``, the
    unpacked short path of each mode) answer index 0, outside the range;
    its packed words and its sparse table are right."""
    mesh, axes = _mesh("2x4")
    x = MAXVAL[dtype]
    l, r = np.array([1, 2, 1]), np.array([2, 2, 1])
    gold = ref.rmq_ref(x, l, r)
    if run == "distributed":
        idx, val = distributed.make_query_fn(mesh, axes)(distributed.build_sharded(x, mesh, axes, 128), l, r)
    else:
        mode, thr, packed = run.split("/")
        packed = None if packed == "None" else packed
        h = sharded_hybrid.build(x, mesh, axes, 128, threshold=int(thr), mode=mode, packed=packed)
        idx, val = sharded_hybrid.query(h, l, r)
    np.testing.assert_array_equal(to_np(idx), gold)
    _same(x[gold], val)
    want = reference[f"maxval/{dtype}/{run}"]
    at_fault = run == "distributed" or run.endswith("/10/None")
    np.testing.assert_array_equal(want, [0, 0, 0] if at_fault else gold)


# --- online patches and durable roots against the reference's child ---------

PATCH_RUNS = {
    "distributed": ("distributed", {}),
    "shard_structure": ("sharded_hybrid", {"mode": "shard_structure"}),
    "shard_batch": ("sharded_hybrid", {"mode": "shard_batch"}),
    "shard_2d": ("sharded_hybrid", {"mode": "shard_2d"}),
    "packed32": ("packed_sharded_hybrid", {"packed": "packed32"}),
}


def _patch_logs(t50, t9000):
    return [
        update.DeltaLog().point(1023, -7.0).point(1024, -7.0),  # tie across a shard boundary
        update.DeltaLog().fill(500, 1600, 0.25),  # a range over three shards
        update.DeltaLog().append(t50),  # inside the blocked capacity
        update.DeltaLog().append(t9000),  # past every capacity: a rebuild
    ]


def _mesh_tree(name, state):
    return state[0] if name == "distributed" else (state.blocked, state.st)


def _port_rebuild(name, online, xm, mesh, axes, kw):
    """A from-scratch port build of ``xm`` with the online engine's resolved
    block size and threshold pinned (a packed engine: under its current
    spec, which a patch keeps while a fresh build would re-derive it)."""
    spec = online.store.current.state.spec if name == "packed_sharded_hybrid" else None
    if spec is not None:  # shard_structure: both tiers over every axis
        return (distributed.build_sharded_packed(xm, mesh, axes, 128, spec),
                distributed.build_sharded_st_packed(xm, mesh, axes, spec))
    if name == "distributed":
        plan = build_mod.plan_for("distributed", xm.shape[0], mesh=mesh, axis_names=axes, block_size=128)
    else:
        thr = int(online.store.current.state.threshold)
        plan = build_mod.plan_for(
            "sharded_hybrid", xm.shape[0], mesh=mesh, axis_names=axes, block_size=128, threshold=thr,
            mode=kw.get("mode", "shard_structure"), packed=kw.get("packed"),
        )
    return _mesh_tree(name, build_mod.execute(plan, xm))


@pytest.mark.parametrize("run", sorted(PATCH_RUNS))
@pytest.mark.parametrize("tag", sorted(MESHES))
def test_mesh_patches_match_reference(reference, tag, run):
    """The online patch sequence of ``tests/test_update.py``'s 8-device
    child (a tie across a shard boundary, a fill over three shards, an
    append inside the blocked capacity, one past every capacity): after
    every log the port's leaves equal the reference's (on a (2, 4) mesh:
    those of the reference's (8,) mesh, but for ``shard_2d``, whose
    structure there has 2 shards), dtypes included, and
    a from-scratch port build of the mutated array; ``patched`` agrees; a
    version pinned before the log keeps its leaves; answers are the
    oracle's."""
    name, kw = PATCH_RUNS[run]
    mesh, axes = _mesh(tag)
    key = f"{tag if run == 'shard_2d' else '8'}/patch/{run}"  # the child's meshes
    x = reference[f"{key}/x"]
    online = update.make_online(name, x, mesh=mesh, axis_names=axes, **kw)
    xm = x.copy()
    rng = np.random.default_rng(8)
    for i, log in enumerate(_patch_logs(reference[f"{key}/t50"], reference[f"{key}/t9000"])):
        old = online.pin()
        before = [to_np(a).copy() for _, a in leaves(_mesh_tree(name, old.state))]
        res = online.apply(log)
        assert res.patched == bool(reference[f"{key}/{i}.patched"]), (i, res)
        for a, (_, b) in zip(before, leaves(_mesh_tree(name, old.state))):
            _same(a, b)  # copy-on-write: the pinned version never changes
        online.release(old.vid)
        xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
        got = leaves(_mesh_tree(name, online.store.current.state))
        assert f"{key}/{i}.leaf{len(got)}" not in reference  # as many leaves
        for j, (_, g) in enumerate(got):
            _same(reference[f"{key}/{i}.leaf{j}"], g)
        for (_, w), (_, g) in zip(leaves(_port_rebuild(name, online, xm, mesh, axes, kw)), got):
            _same(to_np(w), g)
        l, r = rng.integers(0, xm.shape[0], 300), rng.integers(0, xm.shape[0], 300)
        l, r = np.minimum(l, r), np.maximum(l, r)
        ver = online.pin()
        idx, val = online.query(ver.state, l, r)
        online.release(ver.vid)
        gold = ref.rmq_ref(xm, l, r)
        np.testing.assert_array_equal(to_np(idx), gold)
        _same(xm[gold], val)


def test_mesh_durable_root_crosses_packages(reference, tmp_path):
    """``tests/test_fault.py``'s 8-device durable timeline written by the
    port on an 8-shard CPU mesh is the reference child's root byte for byte;
    the reference's root restores in the port on a (2, 4) mesh, leaf for
    leaf equal to the port's live engine, and the port's root restores in
    the reference (in-process, on its one-device mesh) at the same version,
    seq and array."""
    ref_root = reference["durable/root"]
    key = "8/patch/shard_structure"
    x = reference[f"{key}/x"]
    mesh, axes = _mesh("8")
    root = str(tmp_path / "port")
    d = DurableEngine.create("sharded_hybrid", x, root, mesh=mesh, axis_names=axes, mode="shard_structure")
    xm = x.copy()
    for i, log in enumerate(_patch_logs(reference[f"{key}/t50"], reference[f"{key}/t9000"])[:3]):
        d.apply(log)
        xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
        if i == 0:
            d.checkpoint()
    assert [d.current_vid, d.seq] == reference["durable/live"].tolist() == [3, 3]
    a, b = Path(ref_root), Path(root)
    files = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    assert "ckpt/step_00000001/manifest.json" in files
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    mesh24, axes24 = _mesh("2x4")
    pr = DurableEngine.restore(ref_root, mesh=mesh24, axis_names=axes24)
    assert (pr.current_vid, pr.seq, pr.replayed) == (3, 3, 2)
    for (_, w), (_, g) in zip(leaves(_mesh_tree("sharded_hybrid", d.store.current.state)),
                              leaves(_mesh_tree("sharded_hybrid", pr.store.current.state))):
        _same(to_np(w), g)
    jr = jax_fault.DurableEngine.restore(root)
    assert (jr.current_vid, jr.seq, jr.replayed) == (3, 3, 2)
    np.testing.assert_array_equal(np.asarray(jr.store.current.x_host), xm)
    l = np.array([0, 1000, 1023, 2000])
    r = np.array([xm.shape[0] - 1, 1030, 1024, 2100])
    ver = jr.pin()
    np.testing.assert_array_equal(np.asarray(jr.query(ver.state, jnp.asarray(l), jnp.asarray(r))[0]),
                                  ref.rmq_ref(xm, l, r))
    jr.release(ver.vid)
    for e in (d, pr, jr):
        e.close()
