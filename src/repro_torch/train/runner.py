"""Fault-tolerant training runner.

Port of ``repro/train/runner.py``. Wraps a train step with the operational
machinery a long job needs:

  * periodic async checkpoints (atomic; torn writes impossible), in the
    reference's format, so either package resumes the other's;
  * crash recovery: on any step exception, reload the latest complete
    checkpoint and replay — the data pipeline is a pure function of
    (seed, step), so recovery replays the same batches;
  * straggler watchdog: a wall-clock budget per step (median of recent
    steps × multiplier); overruns are logged and counted;
  * retry budget so a persistently failing job stops instead of looping.

``device`` is where batches are made and checkpoints restored (``None``:
CUDA, as every entry point of the port).

On a mesh of ranks (DTensor params, ``train.steps``) every rank runs this
loop over the same batches, a restart included (the pipeline is a function
of the step), and saves and restores together (``checkpoint``: every rank
gathers, rank 0 alone writes); rank 0 alone logs.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch import _dtensor, checkpoint
from repro_torch._device import resolve
from repro_torch._tree import leaves
from repro_torch.data import pipeline as data_pipeline

log = logging.getLogger("repro_torch.runner")
_QUIET = logging.getLogger("repro_torch.runner.other_ranks")  # every rank but 0 logs here: nowhere
_QUIET.disabled = True

__all__ = ["RunnerConfig", "RunnerReport", "run_training"]


@dataclass
class RunnerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    seed: int = 0
    max_retries: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    data_period: int = 0  # >0: cycle the synthetic stream (memorizable)


@dataclass
class RunnerReport:
    steps_done: int = 0
    restarts: int = 0
    straggler_events: int = 0
    losses: list = field(default_factory=list)


def _rank0(params) -> bool:
    """False on every rank of a mesh of ranks but rank 0."""
    if not any(_dtensor.is_dtensor(t) for t in leaves(params)):
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def run_training(
    step_fn: Callable,
    params,
    opt_state,
    cfg,
    batch: int,
    seq_len: int,
    rcfg: RunnerConfig,
    *,
    fault_hook: Callable[[int], None] | None = None,
    device=None,
) -> RunnerReport:
    """Run ``total_steps``, surviving injected/real faults. Returns a report
    whose ``params`` and ``opt_state`` are the final state."""
    dev = resolve(device)
    report = RunnerReport()
    start = 0
    say = log if _rank0(params) else _QUIET

    def restore(step):
        state = checkpoint.restore(rcfg.ckpt_dir, step, {"params": params, "opt": opt_state}, device=dev)
        return state["params"], state["opt"]

    latest = checkpoint.latest_step(rcfg.ckpt_dir)
    if latest is not None:
        params, opt_state = restore(latest)
        start = latest
        say.info("resumed from checkpoint step %d", latest)

    retries = 0
    step = start
    durations: list[float] = []
    while step < rcfg.total_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)  # test hook: raise to simulate a node loss
            data_step = step % rcfg.data_period if rcfg.data_period else step
            batch_data = data_pipeline.synthetic_batch(
                cfg, batch, seq_len, seed=rcfg.seed, step=data_step, device=dev
            )
            t0 = time.monotonic()
            params, opt_state, metrics = step_fn(params, opt_state, batch_data)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.monotonic() - t0
            # straggler detection against the running median
            if len(durations) >= 5:
                med = sorted(durations[-20:])[len(durations[-20:]) // 2]
                if dt > rcfg.straggler_factor * med:
                    report.straggler_events += 1
                    say.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, med)
            durations.append(dt)
            report.losses.append(loss)
            step += 1
            report.steps_done += 1
            retries = 0
            if step % rcfg.ckpt_every == 0 or step == rcfg.total_steps:
                checkpoint.save(
                    rcfg.ckpt_dir, step, {"params": params, "opt": opt_state},
                    background=True, meta={"loss": loss},
                )
            if step % rcfg.log_every == 0:
                say.info("step %d loss %.4f (%.3fs)", step, loss, dt)
        except Exception as e:  # noqa: BLE001 — any fault triggers recovery
            retries += 1
            report.restarts += 1
            say.warning("step %d failed (%s); recovery attempt %d", step, e, retries)
            if retries > rcfg.max_retries:
                raise
            checkpoint.wait_pending()
            latest = checkpoint.latest_step(rcfg.ckpt_dir)
            if latest is not None:
                params, opt_state = restore(latest)
                step = latest
            else:
                step = start

    checkpoint.wait_pending()
    report.params = params
    report.opt_state = opt_state
    return report
