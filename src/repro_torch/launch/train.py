"""Training launcher: real training on the card (or the CPU when asked).

Port of ``repro/launch/train.py``: the reference's flags plus ``--device``
(default: the card; ``cpu`` runs the plain PyTorch path). The mesh is
``(1, n)`` over ``("data", "model")``, the reference's, over every device
it has, one rank per device (``launch/ranks.py``):

  * under ``torchrun`` (``WORLD_SIZE`` set) each process joins its group
    (NCCL on the cards, gloo with ``--device cpu``) and ``n`` is the world
    size;
  * on a machine with ``n > 1`` cards and no such environment, it starts
    the ``n`` ranks itself and rank 0 prints the result;
  * on one card, or with ``--device cpu`` outside ``torchrun``, one process
    trains on a ``(1, 1)`` mesh of its one device.

Every rank initialises the whole params from ``--seed`` on its device and
keeps its shards of them. ``--production-mesh`` (the reference's 16 x 16
on the ``meta`` device, a shape to plan against) raises ``ValueError``.
``--ckpt-dir``
defaults to ``build/ckpt/<arch>`` (``<arch>-smoke`` with ``--smoke``) in
this checkout, where the reference's is a fixed ``/tmp/repro_ckpt``: a run
resumes from that directory's latest checkpoint, so runs of other
checkouts, other users or other configs do not share one.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 50 --batch 8 --seq-len 128 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --device cpu --arch granite-3-8b --smoke --steps 20
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from repro_torch._device import resolve
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_mesh, set_mesh
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import runner as runner_lib
from repro_torch.train.steps import make_train_step, place_state


def default_ckpt_dir(arch: str, smoke: bool) -> Path:
    """``build/ckpt/<arch>[-smoke]`` under the checkout holding this file."""
    return Path(__file__).resolve().parents[3] / "build" / "ckpt" / (arch + ("-smoke" if smoke else ""))


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None, help="default: build/ckpt/<arch>[-smoke] in the checkout")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns the runner's report (``None`` in the
    process that started ranks of its own, and on every rank but 0)."""
    args = _parse(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    if args.production_mesh:
        raise ValueError(
            "--production-mesh is the reference's 16x16 pod, which the port holds only on the meta "
            "device (a shape to plan against); it cannot train. Drop the flag to train on this machine."
        )
    dev = resolve(args.device)
    if ranks.launched():
        ranks.join(dev.type)
        try:
            return _train(args)
        finally:
            ranks.leave()
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n > 1:
        ranks.spawn(_rank_main, n, args, device_type=dev.type)
        return None
    return _train(args, dev)


def _rank_main(rank: int, args) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    _train(args)


def _train(args, dev=None):
    """One process's run: on ``dev`` alone, or, with ``dev`` None, as a rank
    of the group this process belongs to."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if dev is None:
        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
        mesh = make_mesh((1, world), ("data", "model"))
        dev = mesh.rank_device
    else:
        world, rank = 1, 0
        mesh = make_mesh((1, 1), ("data", "model"), devices=dev)

    with set_mesh(mesh):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = model_lib.init_params(cfg, generator=gen, device=dev)
        opt_state = adamw.init(params)
        step_fn, info = make_train_step(
            cfg, mesh,
            lr_fn=adamw.cosine_schedule(args.lr, 10, args.steps),
            batch=args.batch, seq_len=args.seq_len,
            microbatches=args.microbatches,
        )
        params, opt_state = place_state(mesh, info, params, opt_state)
        rcfg = runner_lib.RunnerConfig(
            total_steps=args.steps, ckpt_dir=args.ckpt_dir or str(default_ckpt_dir(args.arch, args.smoke)),
            ckpt_every=args.ckpt_every, seed=args.seed,
        )
        report = runner_lib.run_training(
            step_fn, params, opt_state, cfg, args.batch, args.seq_len, rcfg, device=dev
        )
    if rank:
        return None
    losses = (
        f", first loss {report.losses[0]:.4f}, last loss {report.losses[-1]:.4f}"
        if report.losses else " (the checkpoints already hold every step)"
    )
    where = f"{world} ranks on {mesh!r}" if world > 1 else str(dev)
    print(
        f"done: {report.steps_done} steps{losses}, restarts {report.restarts} on {where}"
        + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
    )
    return report


if __name__ == "__main__":
    main()
