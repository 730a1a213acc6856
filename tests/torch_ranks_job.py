"""The ranks' side of ``tests/test_torch_train_ranks.py``: four gloo ranks on
the CPU, started with a ``FileStore`` rendezvous. Imports no JAX.

    python tests/torch_ranks_job.py OUT

``OUT/init.npz`` holds the initial params of the trained configs (keys
``<arch>/<path>``, written by the test). The job writes:

  * ``OUT/ranks.json``: for each placement case and leaf, the block
    ``[[start, stop], ...]`` of the whole leaf that each rank's shard holds
    (``"mismatch"`` where a shard is no such block); for each trained
    config the losses, grad norms and lrs of its three steps, whether every
    rank saw the same metrics, whether the restored checkpoint equals the
    live state shard for shard, and the compression and norm checks; for
    each served config, per rank, the prefill's and decode steps' errors
    against whole tensors and whether a used cache was refused; per rank,
    ``run_training`` through a fault against a run without one;
  * ``OUT/variant_<name>.npz``: two steps with microbatches, and one with
    gradient compression;
  * ``OUT/final_<arch>.npz``: the state after three steps, whole (keys
    ``p/<path>``, ``o/master/<path>``, ``o/mu/<path>``, ``o/nu/<path>``,
    ``o/step``);
  * ``OUT/ckpt_<arch>/step_00000003``: the ranks' checkpoint of that state.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

WORLD = 4
B, L, STEPS = 2, 16, 3  # test_torch_train_parity.py's shape, where its tolerances were measured
LR = (1e-3, 1, 4)  # adamw.cosine_schedule(base, warmup, total)
TRAINED = ("granite-3-8b", "grok-1-314b")  # held to the reference's (2, 2) step too
F_SHARDED = "grok-1-314b-3-experts"  # 3 experts: F, not the experts, over "model"
RANK_TRAINED = TRAINED + (F_SHARDED, "mamba2-2.7b")  # the last two held to one device alone
AXES = ("data", "model")


def placement_cases():
    """(name, arch, mesh shape, axes, parallelism): the ten configs on (2, 2)
    and (1, 4), granite pure-FSDP on (2, 2) (("data", "model") on one
    dimension) and granite on a (2, 2, 1) pod mesh (("pod", "data"))."""
    from repro_torch.configs import ARCH_IDS

    cases = [(f"{a}|{s[0]}x{s[1]}|2d", a, s, AXES, "2d") for s in ((2, 2), (1, 4)) for a in ARCH_IDS]
    cases.append(("granite-3-8b|2x2|fsdp", "granite-3-8b", (2, 2), AXES, "fsdp"))
    cases.append(("granite-3-8b|2x2x1|2d", "granite-3-8b", (2, 2, 1), ("pod", "data", "model"), "2d"))
    return cases


def trained_config(name):
    """The reduced config a trained case runs: grok at capacity factor 1.0,
    so its two MoE groups drop tokens and route apart from one group; with
    3 experts, which do not split over a model axis of 2 (``F_SHARDED``)."""
    from repro_torch.configs import get_config, reduce_for_smoke

    cfg = reduce_for_smoke(get_config(name.removesuffix("-3-experts")))
    if name == F_SHARDED:
        cfg = dataclasses.replace(cfg, num_experts=3)
    return dataclasses.replace(cfg, capacity_factor=1.0) if cfg.num_experts else cfg


def flat(tree, prefix=""):
    """``{"a/b": leaf}`` of a nest of dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def nest(arrays: dict, prefix: str) -> dict:
    """The nest of dicts under ``prefix`` of ``"a/b/c"`` keys."""
    out = {}
    for key, v in arrays.items():
        if key.startswith(prefix):
            *parents, leaf = key[len(prefix):].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def _blocks(local: torch.Tensor, whole: torch.Tensor):
    """The ``[[start, stop], ...]`` block of ``whole`` (an arange) that
    ``local`` is, or "mismatch"."""
    if local.numel() == 0:
        return "mismatch"
    start = np.unravel_index(int(local.reshape(-1)[0]), tuple(whole.shape))
    block = tuple(slice(int(s), int(s) + n) for s, n in zip(start, local.shape))
    if not torch.equal(local, whole[block]):
        return "mismatch"
    return [[b.start, b.stop] for b in block]


def placements(rank, cases):
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model

    out = {}
    for name, arch, shape, axes, parallelism in cases:
        cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), parallelism=parallelism)
        mesh = make_mesh(shape, axes)
        whole = {k: torch.arange(math.prod(s), dtype=torch.int64).reshape(s) for k, s in flat(model.param_shapes(cfg)).items()}
        placed = flat(sharding.place(mesh, sharding.param_specs(cfg, mesh), nest(whole, "")))
        out[name] = {k: _blocks(placed[k].to_local(), whole[k]) for k in whole}
    return out


def train(rank, out: Path, arch: str) -> dict:
    import torch.distributed as dist

    from repro_torch import _dtensor, checkpoint, convert
    from repro_torch._tree import leaves, tree_map
    from repro_torch.data import pipeline
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw, compress
    from repro_torch.train.steps import make_train_step, place_state

    cfg = trained_config(arch)
    init = dict(np.load(out / "init.npz"))
    params = convert.model_params(nest(init, f"{arch}/"), "cpu")
    opt = adamw.init(params)
    mesh = make_mesh((2, 2), AXES)
    step, info = make_train_step(cfg, mesh, lr_fn=adamw.cosine_schedule(*LR), batch=B, seq_len=L)
    params, opt = place_state(mesh, info, params, opt)
    laid_out = all(
        tuple(t.placements) == s.placements
        for t, s in zip(leaves((params, opt)), leaves(sharding.named(mesh, (info["params"], info["opt"])), lambda x: isinstance(x, sharding.Sharding)))
    )
    metrics = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, pipeline.synthetic_batch(cfg, B, L, seed=0, step=i, device="cpu"))
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    seen = [None] * WORLD
    dist.all_gather_object(seen, metrics)

    whole = tree_map(_dtensor.full, (params, opt))
    if rank == 0:
        p, o = whole
        arrays = {f"p/{k}": v.numpy() for k, v in flat(p).items()}
        for f in ("master", "mu", "nu"):
            arrays.update({f"o/{f}/{k}": v.numpy() for k, v in flat(getattr(o, f)).items()})
        np.savez(out / f"final_{arch}.npz", **arrays, **{"o/step": o.step.numpy()})

    root = str(out / f"ckpt_{arch}")
    checkpoint.save(root, STEPS, {"params": params, "opt": opt})
    where = {"params": sharding.named(mesh, info["params"]), "opt": sharding.named(mesh, info["opt"])}
    back = checkpoint.restore(root, STEPS, {"params": params, "opt": opt}, shardings=where)
    restored = all(
        tuple(a.placements) == tuple(b.placements) and torch.equal(a.to_local(), b.to_local())
        for a, b in zip(leaves((params, opt)), leaves((back["params"], back["opt"])))
    )

    g = opt.master["embed"]  # sharded over both axes on (2, 2)
    q, scale = compress.compress(g)
    qw, scale_w = compress.compress(g.full_tensor())
    norm, norm_w = adamw.global_norm(opt.mu), adamw.global_norm(whole[1].mu)
    return {
        "metrics": metrics,
        "ranks_agree": all(s == metrics for s in seen),
        "laid_out": laid_out,
        "restored": restored,
        "compress_whole": bool(torch.equal(q.full_tensor(), qw) and torch.equal(scale.full_tensor(), scale_w)),
        "norm": [float(_dtensor.full(norm)), float(norm_w)],
    }


SERVED = ("granite-3-8b", "mamba2-2.7b")  # a sequence-sharded K/V cache; SSM states sharded by head
PROMPT, DECODE = 16, 4


def serve(rank, arch: str) -> dict:
    """Prefill and ``DECODE`` decode steps on the (2, 2) mesh of ranks
    against the same on whole tensors: the largest difference of each
    step's logits over their largest magnitude; and whether a decode from a
    used cache is refused, as on one device."""
    from repro_torch import _dtensor
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.train.steps import make_prefill_step, make_serve_step, place_state

    cfg = reduce_for_smoke(get_config(arch))
    params = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, PROMPT + DECODE)).astype(np.int32))
    mesh = make_mesh((2, 2), AXES)
    prefill, info = make_prefill_step(cfg, mesh, batch=B, seq_len=PROMPT)
    decode, _ = make_serve_step(cfg, mesh, batch=B, capacity=PROMPT + cfg.cache_pad)
    placed = place_state(mesh, info, params)

    def err(got, want):
        return float((_dtensor.full(got) - want).abs().max() / want.abs().max())

    logits, cache = prefill(placed, tokens[:, :PROMPT])
    want, wcache = model.prefill(params, tokens[:, :PROMPT], cfg)
    errs = [err(logits, want)]
    for t in range(PROMPT, PROMPT + DECODE):
        used = cache
        logits, cache = decode(placed, tokens[:, t : t + 1], cache)
        want, wcache = model.decode_step(params, tokens[:, t : t + 1], wcache, cfg)
        errs.append(err(logits, want))
    try:
        decode(placed, tokens[:, -1:], used)
        refused = False
    except ValueError:
        refused = True
    return {"errs": errs, "stale_refused": refused}


VARIANTS = {  # make_train_step's options on ranks, and the steps each takes
    "microbatches": (dict(microbatches=2), 2),
    "grad_compress": (dict(grad_compress=True), 1),
}


def variant(rank, out: Path, name: str) -> None:
    """Reduced granite on the (2, 2) mesh of ranks with a ``VARIANTS`` option
    of ``make_train_step`` and its steps, from ``init.npz``; rank 0 writes
    the losses and the whole AdamW state to ``OUT/variant_<name>.npz``."""
    from repro_torch import _dtensor, convert
    from repro_torch._tree import tree_map
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step, place_state

    cfg = trained_config("granite-3-8b")
    mesh = make_mesh((2, 2), AXES)
    options, steps = VARIANTS[name]
    step, info = make_train_step(cfg, mesh, lr_fn=adamw.cosine_schedule(*LR), batch=B, seq_len=L, **options)
    params = convert.model_params(nest(dict(np.load(out / "init.npz")), "granite-3-8b/"), "cpu")
    params, opt = place_state(mesh, info, params, adamw.init(params))
    losses = []
    for i in range(steps):
        params, opt, m = step(params, opt, pipeline.synthetic_batch(cfg, B, L, seed=0, step=i, device="cpu"))
        losses.append(float(m["loss"]))
    opt = tree_map(_dtensor.full, opt)
    if rank == 0:
        arrays = {f"{f}/{k}": v.numpy() for f in ("master", "mu", "nu") for k, v in flat(getattr(opt, f)).items()}
        np.savez(out / f"variant_{name}.npz", losses=np.array(losses), step=opt.step.numpy(), **arrays)


def runner_fault(rank, out: Path) -> dict:
    """``run_training`` of reduced granite on the (2, 2) mesh of ranks, 4
    steps with a checkpoint every 2 and a fault at step 3 on every rank,
    beside the same run without the fault: the restarts, the steps done and
    whether the two final states are equal bit for bit."""
    from repro_torch import convert
    from repro_torch._tree import leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import runner
    from repro_torch.train.steps import make_train_step, place_state

    cfg = trained_config("granite-3-8b")
    mesh = make_mesh((2, 2), AXES)
    step, info = make_train_step(cfg, mesh, lr_fn=adamw.cosine_schedule(1e-3, 1, 4), batch=B, seq_len=L)
    params = convert.model_params(nest(dict(np.load(out / "init.npz")), "granite-3-8b/"), "cpu")
    params, opt = place_state(mesh, info, params, adamw.init(params))
    boom = {3: True}

    def hook(s):
        if boom.pop(s, None):
            raise RuntimeError("injected fault")

    reports = [
        runner.run_training(step, params, opt, cfg, B, L,
                            runner.RunnerConfig(total_steps=4, ckpt_dir=str(out / f"runner_{name}"), ckpt_every=2),
                            fault_hook=fault, device="cpu")
        for name, fault in (("fault", hook), ("clean", None))
    ]
    same = all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(*(leaves(r.opt_state) for r in reports)))
    return {"restarts": reports[0].restarts, "steps_done": reports[0].steps_done, "same": same,
            "losses": [r.losses for r in reports]}


def work(rank: int, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(out)
    mine = {"placements": placements(rank, placement_cases())}
    for arch in RANK_TRAINED:
        mine[arch] = train(rank, out, arch)
    mine["served"] = {arch: serve(rank, arch) for arch in SERVED}
    mine["runner"] = runner_fault(rank, out)
    for name in VARIANTS:
        variant(rank, out, name)
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    if rank == 0:
        cases = {name: {k: [r["placements"][name][k] for r in every] for k in mine["placements"][name]}
                 for name in mine["placements"]}
        trained = {arch: {**mine[arch], "all_ranks": {key: all(r[arch][key] for r in every)
                                                      for key in ("ranks_agree", "laid_out", "restored", "compress_whole")}}
                   for arch in RANK_TRAINED}
        served = {arch: [r["served"][arch] for r in every] for arch in SERVED}
        runs = [r["runner"] for r in every]
        (out / "ranks.json").write_text(json.dumps({"placements": cases, "trained": trained, "served": served, "runner": runs}))


if __name__ == "__main__":
    from repro_torch.launch import ranks

    out = Path(sys.argv[1]).resolve()
    ranks.spawn(work, WORLD, str(out), device_type="cpu", init_method=f"file://{out / 'rendezvous'}")
    print("RANKS_OK")
