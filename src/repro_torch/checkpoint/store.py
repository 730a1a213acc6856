"""Atomic, optionally async checkpoints of tensor trees, in the reference's format.

Layout: ``<root>/step_<N>/`` holding one ``.npy`` per tree leaf plus
``manifest.json`` (tree paths, shapes, dtypes, meta). Writes go to a temp
dir and are renamed into place, so a killed job never leaves a torn
checkpoint (restart reads the latest *complete* step). Older steps stay on
disk, as in the reference.

The format is ``repro/checkpoint/store.py``'s, file for file: a tree is a
nest of dicts, lists, tuples and NamedTuples, flattened in
``jax.tree_util``'s order and named by its ``keystr`` (dict keys sorted and
written ``['name']``, sequence items ``[i]``, NamedTuple fields ``.name``),
and tensors are saved as numpy arrays of the same dtype. A bfloat16 leaf,
which numpy has no dtype for, is written as the reference writes it through
``ml_dtypes``: its raw 2-byte words under the ``.npy`` descr ``'<V2'``,
with ``"dtype": "bfloat16"`` in the manifest, and read back through the
same words. So either package restores the other's checkpoints. ``restore`` puts the leaves back as
tensors on ``device``, or (``shardings=``, the reference's elastic restore)
each leaf where its placement says: a ``torch.device``, or a
``core.distributed.Placement`` that splits it over a mesh axis, whatever
mesh the restoring job has.

Async: ``save(..., background=True)`` copies to host memory synchronously
and writes to disk on a daemon thread.

Ranks: a tree of DTensors (a run on a mesh of ranks, ``train.steps``) is
saved by every rank together, and written as a one-device run writes it:
each leaf whole (``full_tensor()``, a collective, leaf after leaf), the
files written by rank 0 alone, and a barrier once the rename is done
(``wait_pending`` for a background save), so no rank sees the step before
it is complete. ``restore`` lays the leaves out again: as ``shardings``
says (``launch.sharding.named``), or, without it, as the DTensor leaves of
``like`` are.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch import _dtensor
from repro_torch._device import resolve
from repro_torch._tree import children as _children
from repro_torch._tree import rebuild

__all__ = [
    "latest_step",
    "load_snapshot",
    "restore",
    "save",
    "save_snapshot",
    "wait_pending",
]

_PENDING: list[threading.Thread] = []
_RANK_SAVES: list[bool] = []  # a rank save awaits its barrier in ``wait_pending``

_BF16 = "bfloat16"
_BF16_DESCR = "<V2"  # what numpy writes for ml_dtypes' bfloat16


def _host(leaf) -> tuple:
    """``(numpy array, manifest dtype)`` of a leaf, copied to host memory. A
    bfloat16 tensor becomes its raw words as a ``V2`` array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2"), _BF16
        leaf = t.numpy()
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _write_npy(f, a: np.ndarray, dtype: str) -> None:
    """``np.save``, except that a bfloat16 leaf gets the reference's header."""
    if dtype != _BF16:
        np.save(f, a)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": a.shape}
    )
    f.write(np.ascontiguousarray(a).tobytes())


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded ``.npy`` array as a tensor; a bfloat16 leaf from its words."""
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree, prefix: str = "") -> list:
    """``[(key, leaf)]`` as ``jax.tree_util.tree_flatten_with_path`` and
    ``keystr`` give them; ``None`` holds no leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [kv for k, v in kids for kv in _flatten(v, prefix + k)]


def _unflatten(like, leaves: Iterator):
    """``like`` rebuilt with its leaves taken in ``_flatten`` order."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    return rebuild(like, [_unflatten(v, leaves) for _, v in kids])


def save(
    root: str,
    step: int,
    tree: Any,
    *,
    background: bool = False,
    meta: dict | None = None,
    fault: Optional[Callable[[str], None]] = None,
):
    """Checkpoint ``tree`` at ``step``. Atomic (write-temp-fsync-rename).

    Every leaf and the manifest are fsynced before the rename, and the
    parent directory after it: a power loss at any point leaves either the
    previous checkpoint or the new one, never a torn mix (``latest_step``
    ignores ``.tmp`` leftovers). ``fault`` is an optional ``check(site)``
    callable fired at the ``checkpoint_write`` site after the leaf writes
    but before the manifest/rename — the widest crash window.
    """
    flat = _flatten(tree)
    ranks = any(_dtensor.is_dtensor(v) for _, v in flat)
    writer = not ranks or _rank() == 0
    # Copy to host memory first (a device -> host copy for CUDA tensors) so
    # async writers never race live buffers. On ranks each leaf is gathered
    # whole by every rank, and kept by the writer alone.
    host = []
    for k, v in flat:
        v = _dtensor.full(v)
        if writer:
            host.append((k, *_host(v)))
    manifest = {
        "step": int(step),
        "leaves": [
            {"key": k, "shape": list(a.shape), "dtype": dt, "file": f"leaf_{i}.npy"}
            for i, (k, a, dt) in enumerate(host)
        ],
        "meta": meta or {},
    }

    def write():
        final = os.path.join(root, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        for i, (_, a, dt) in enumerate(host):
            with open(os.path.join(tmp, f"leaf_{i}.npy"), "wb") as f:
                _write_npy(f, a, dt)
                f.flush()
                os.fsync(f.fileno())
        if fault is not None:
            # A crash here leaves a durable-but-manifestless temp dir, which
            # restore ignores — exactly a death between leaf writes and
            # publication. The torn temp stays on disk, like a real crash.
            fault("checkpoint_write")
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        _fsync_dir(root)

    if ranks:
        _RANK_SAVES.append(True)
    if writer and background:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
    elif writer:
        write()
    if ranks and not background:
        wait_pending()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def wait_pending():
    """Wait for the background writes; after a save of DTensors every rank
    calls it, and meets the others once rank 0's files are in place."""
    for t in _PENDING:
        t.join()
    _PENDING.clear()
    if _RANK_SAVES:
        _RANK_SAVES.clear()
        import torch.distributed as dist

        dist.barrier()


def latest_step(root: str) -> int | None:
    """Highest *complete* checkpoint step (tmp dirs are ignored)."""
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(root, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


# Keys of a plain-dict tree flatten to "['name']".
_DICT_KEY = re.compile(r"^\['(.*)'\]$")


def save_snapshot(
    root: str,
    step: int,
    arrays: dict,
    meta: dict,
    *,
    fault: Optional[Callable[[str], None]] = None,
) -> None:
    """Atomically snapshot a named-array dict (engine structure leaves).

    The durability half of ``fault.durable.DurableEngine.checkpoint``:
    ``arrays`` is an engine's host-side structure leaves keyed by name,
    ``meta`` the JSON-serializable identity needed to rebuild it (engine
    name, version id, journal seq, build kwargs). ``step`` is conventionally
    the journal seq the snapshot covers, so ``latest_step`` finds the most
    recent durable point.
    """
    save(root, step, dict(arrays), meta=dict(meta), fault=fault)


def load_snapshot(root: str, step: int | None = None):
    """Load a ``save_snapshot`` checkpoint -> ``(arrays, meta, step)``.

    ``step=None`` loads the latest complete checkpoint; raises
    ``FileNotFoundError`` when the root holds none.
    """
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root!r}")
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = {}
    for e in manifest["leaves"]:
        m = _DICT_KEY.match(e["key"])
        key = m.group(1) if m else e["key"]
        arrays[key] = np.load(os.path.join(path, e["file"]))
    return arrays, manifest["meta"], int(step)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def restore(root: str, step: int, like: Any, *, device=None, shardings: Any = None) -> Any:
    """Load a checkpoint into the structure of ``like``, every leaf a tensor
    on ``device`` (``None``: CUDA).

    ``shardings``: optional tree matching ``like`` whose leaves are each a
    ``torch.device`` (the whole leaf there), a
    ``core.distributed.Placement`` (the leaf split into a ``ShardedLeaf``
    over a mesh axis) or a ``launch.sharding.Sharding`` (a DTensor on a
    mesh of ranks) — elastic restore onto whatever mesh the restarted
    job has; ``device`` is then unused. Without it, a DTensor leaf of
    ``like`` comes back a DTensor laid out as it is.
    """
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    flat = _flatten(like)
    if shardings is None:
        dev = None if all(_dtensor.is_dtensor(ref) for _, ref in flat) else resolve(device)
        places = [_like(ref, dev) for _, ref in flat]
    else:
        targets = _flatten(shardings)
        for k, ks in itertools.zip_longest([k for k, _ in flat], [k for k, _ in targets]):
            if k != ks:
                raise ValueError(f"shardings leaves differ from the tree's: {ks} where the tree has {k}")
        places = [_placer(t) for _, t in targets]
    leaves = []
    for (k, ref), place in zip(flat, places):
        e = by_key[k]
        a = np.load(os.path.join(path, e["file"]))
        if a.shape != _shape(ref):
            raise ValueError(f"checkpoint leaf {k} has shape {a.shape}, the tree wants {_shape(ref)}")
        leaves.append(place(_tensor(a, e["dtype"])))
    return _unflatten(like, iter(leaves))


def _like(ref, dev) -> Callable:
    """``host tensor -> leaf`` placed as ``ref``: a DTensor's layout, else
    whole on ``dev``."""
    if _dtensor.is_dtensor(ref):
        return lambda t: _dtensor.place(t, ref.device_mesh, ref.placements)
    return lambda t: t.to(dev)


def _placer(target) -> Callable:
    """``host tensor -> leaf`` for one ``shardings`` leaf."""
    if hasattr(target, "place"):  # core.distributed.Placement
        return target.place
    dev = resolve(target)
    return lambda t: t.to(dev)
