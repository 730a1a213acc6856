"""Smoke run of repro_torch on one CUDA card: kernels, served paths, numbers.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and nvcc versions,
   the checkout's filesystem (``df -T`` type, ``os.statvfs`` free bytes),
   and the build of the CUDA kernels from ``src/repro_torch/csrc``;
2. ``block_min`` kernel vs its plain PyTorch version at nb = 2^19 rows,
   bs in {128, 256}, float32 and tie-heavy int32: values and lanes equal;
3. ``fused_query`` kernel vs plain, ``resident`` at n = 2^20 and ``dma`` at
   n = 2^26 (and each fetch at the other size, timed too), B in
   {4096, 4099}: indices and values equal, and the two fetches equal;
4. ``fused_query_packed`` vs plain: packed32 at n = 2^20 int32 (key span
   49) and on the Euler-tour depth array of a complete binary tree of
   height 24 (n = 2^26 - 3, depths 0..24: the +-1 RMQ that LCA queries
   reduce to, and a key span that packed32 holds, 25 << 26 < 2^31), both
   fetches, equal to each other; quantized at n = 2^20 and 2^26, float32
   and int32; packed64 at n = 2^26, float32 and int32, both fetches, equal
   to each other. Then ``rmq_partials`` and ``lane_partials`` vs plain at
   n = 2^26 float32 and int32, ``ops.query(fused=False)`` equal to
   ``ops.query`` and ``ops.lane_query`` equal to ``core.lane_rmq.query``,
   both checked against the oracle on a sample. B in {4096, 4099}, bit for
   bit. Then ``sparse_query`` (the hybrid's long path) vs its plain chain
   at the benchmark cell's n = 10^8, float32 and int32, on 2^22 lengths
   uniform in [1, n] and ``doubling_edges``: bit for bit, timed beside the
   plain chain. Also timed: packed32 and ``lane_partials`` for one query (B = 1,
   their floor), and ``lane_partials`` on lengths uniform in [1, 128]
   (about half inside one lane block). Then every kernel against its plain
   version on ``kernels.edge_batch`` (ranges cut at 4j, 4j+3 and mid-piece,
   ties across rows, lanes and pieces, zeros of both signs, maxval minima,
   quantized bucket collisions; packed32 on its small-span values, packed64
   on the batch's own, int32 and float32) at bs in {128, 256}, B in {1, 4099}, tiles 1 and 8, and
   ``lane_partials`` also on a batch whose queries all lie inside single
   lane blocks (a quarter of them in the maxval blocks). Every query of
   those batches whose range holds only maxval is also held to the numpy
   oracle (kernel equal to plain cannot show the maxval-only fault: both
   were wrong together), for every kernel but packed32;
5. the served paths. Through ``repro_torch.launch.serve.main``: hybrid and
   fused128 oneshot at n = 2^26, hybrid oneshot at n = 2^20 and at
   ``RESIDENT_NB_CEILING`` blocks (the largest n whose "auto" fetch is
   resident: 2048 values), hybrid async at n = 2^26 with small and medium
   ranges; packed_hybrid --packed quantized at n = 2^26 oneshot and async;
   packed_hybrid at n = 2^26 with the layout left to the data (float32:
   packed64, on its kernel). Through the library: packed_hybrid
   packed32 on the Euler array, at n = 2^20 and at the resident ceiling, and
   ``ops.query(fused=False)`` and ``ops.lane_query`` at n = 2^26. Every
   answer is checked against the numpy oracle; the launch counts are set to
   0 just before each run and read just after, and each run must have
   launched its kernels. Then the
   maxval-only inputs: [0, inf, inf] and [5, INT32_MAX, INT32_MAX] through
   block128, block256, lane, fused128, fused128_dma, hybrid (its sqrt(n)
   threshold sends them to the kernel) and exhaustive, and arrays of
   n = 2^20 (float32, int32) with maxval runs that cross blocks through the
   blocked engines, ``ops.query(fused=False)``, ``ops.lane_query`` and
   quantized packed_hybrid: every answer the oracle's;
6. the traced async hybrid run (the device's idle share);
7. the measured crossover and the autotuner, with the calibration cache in
   a temporary file of this run (``RMQ_TORCH_CALIB_CACHE``; every earlier
   phase found it empty, so served at the sqrt(n) threshold and the default
   kernel geometry): ``hybrid.calibrate`` at n = 2^26 and 2^20, unpacked,
   quantized and packed32, each crossover beside sqrt(n); ``tuning.sweep``
   at n = 2^26 and 2^20 (B = 4096), twice, every candidate's time and
   whether the two runs agree on the winner; ``--engine hybrid --calibrate
   --tune`` async at n = 2^26 with small ranges (measures and stores) and
   medium ranges (must measure nothing: the cache hit); the baselines:
   ``--engine lca`` oneshot (every query of a batch checked) and async at
   n = 2^20, and ``exhaustive`` through the registry at n = 2^20 on 4096
   queries and on an all-equal array (leftmost ties on CUDA), each checked
   against the oracle and launching no kernel;
7b. online updates: ``--engine hybrid --mode async --mutate 8`` at
   n = 2^26 through ``launch.serve.main`` (the reference's Poisson mutator,
   seed 77), its clients paced to keep sending while the eight batches
   apply (4 x 400 requests at 4 per second) and its threshold pinned to
   ``ONLINE_THRESHOLD`` in this run's cache, so the `small` lengths split
   between the blocked path and the patched full-array table: every
   request equal to the oracle of its pinned version, some of them served
   at a version between the first and the last (so while a later batch
   applied), no kernel launched (the online hybrid pins the plain short
   path, as the reference does); the online build, each publish's time and
   ``publish_bytes``, update p50/p99, the version lags, the requests per
   served version and the peak device memory. Through the library at
   n = 2^20: sparse_table, block128, block256, hybrid (threshold 64, which
   splits the `small` lengths) and packed_hybrid (packed32 on small-span
   int32, whose append
   overflows the index field and rebuilds; quantized; float32 auto ->
   packed64), each through a point write, a fill and an append: the oracle
   after every update, a version pinned before them answering from its own
   tensors, and the final state equal to a from-scratch build on the card
   leaf for leaf, dtypes included;
7c. durability, under ``build/durable/`` (removed at the end; it fails
   unless the filesystem holds the two checkpoints of (a)). (a) Through the
   library at n = 2^26 float32 (seed 0), ``hybrid`` (threshold
   ``ONLINE_THRESHOLD``) on the card: ``DurableEngine.create`` (the base
   checkpoint), two write batches of phase 7b's mutator (seed 77), a
   ``checkpoint()`` while 4 clients send `small` requests through an
   ``RMQServer`` over the durable engine, one more write batch and an
   append (the journal suffix), host copies of the live leaves, then a
   crash (``close()``, the engine dropped) and ``DurableEngine.restore``:
   2 records replayed, the same version and seq, every leaf bit-identical
   to the live copy and equal to a from-scratch ``make_online`` of the
   oracle array, and ``RMQServer(restore=...)`` answering 4 x 32 x 256
   `small` queries as the oracle; the build, each checkpoint's seconds and
   bytes on disk, each journal append (its fsync) beside the batch's apply,
   the restore split into load, upload and replay, request p50/p99 during
   the checkpoint, and the peak device memory. (b) ``--engine hybrid --mode
   async --mutate 4 --restore DIR --n 2^20`` twice on one DIR: the second
   run prints the restore line (version 4, seq 4, 4 records replayed) and
   goes on at versions 5-8; both verify every request. (c) ``--chaos 7 --n
   2^20`` for each updatable engine: every report ``[OK]``, with at least
   one recovered apply failure and one failed checkpoint. No kernel is
   launched (the durable engines wrap the online ones);
7d. the mesh engines (``mesh_phase``), on a ``(2, 4)`` mesh ("data",
   "model") of 8 shards round-robin over the visible cards (all on
   ``cuda:0`` with one card), n = 2^26 float32 (phases 1-6's array), one
   engine at a time with the memory freed between: ``sharded_hybrid`` in
   each mode (the sharded table's global view equal to
   ``sparse_table.build`` and x[idx] on the card, each blocked shard equal
   to ``block_rmq.build`` of its chunk; build s and peak memory, which for
   ``shard_batch`` and ``shard_2d`` must stay within 1.1 x
   ``shard_structure``'s; 4096 `small` and 4096 `medium` queries timed;
   4 x 32 x 256 of each served at 200/s, every request held to the oracle,
   p50/p99, the device idle share of a traced `small` window), then
   ``distributed`` (bs 1024) on an ``(8,)`` mesh, ``packed_sharded_hybrid``
   on the float array (auto -> packed64) and packed32 on the Euler depths;
   each also on ``edge_batch`` and the maxval-only inputs; every index
   equal to the single-device ``hybrid``'s and to the oracle. Then
   ``hybrid.calibrate(2^26, mesh=)`` for ``shard_structure`` and
   ``shard_2d``, and the serve CLI's ``--engine sharded_hybrid --qshard 2d
   --mode async`` and ``--engine distributed`` on the card's default mesh
   (one shard). No kernel is launched (the mesh engines run the plain
   paths, as the reference's run no Pallas kernel);
7e. online and durable mesh engines (``mesh_online_phase``) at
   n = 2^26 - 71 float32 (odd, so every structure keeps padded columns)
   and on the Euler depths, one engine at a time: ``update.make_online``
   for ``sharded_hybrid`` in each mode on the ``(2, 4)`` mesh,
   ``distributed`` (bs 1024) on ``(8,)`` and ``packed_sharded_hybrid``
   packed32 on the Euler array, each through the reference child's four
   logs scaled to n (a tie across the boundary of shards 0 and 1, a fill
   over shards 0-2, an append of as many values as the padded capacity
   holds, at most 50, and one of 9000 past it: a rebuild, but
   ``shard_batch``'s host mirrors grow and patch); after each log 4096
   `small` and 4096 `medium` queries held to the oracle of that version;
   after the last patch and at the end every leaf equal to a fresh build of
   the mutated array; per apply its ms, ``patched``, device operations
   (``torch.profiler``) and peak bytes. Then ``DurableEngine`` on ``(8,)``
   for ``sharded_hybrid`` and ``distributed``: three logs, a checkpoint
   after the first (the array only: its bytes and seconds), a restore that
   replays two (seconds), leaf for leaf equal to the live engine; under
   ``build/durable/``, removed at the end. No kernel is launched;
7f. the fleet (``fleet_phase``) at n = 2^24 (``N_FLEET``: three replicas
   each hold a whole structure): ``run_fleet_soak`` on ``hybrid`` (3
   durable replicas, ``max_lag`` 2, 8 updates over 240 requests of 256
   queries, an injected mid-rollout crash and an external crash +
   restore), then on ``sharded_hybrid`` with 8 positions of the card (3
   replicas x 2); lost requests, mismatches and read-your-writes
   violations must be 0 and the lag within ``max_lag``; each prints its
   rollouts' time to the first and to the last publish, request p50/p99
   and the peak bytes. Then the serve CLI's ``--engine hybrid --mode async
   --replicas 3 --max-lag 2 --mutate 4`` (4 clients x 32 x 256 `small`
   at 200/s each), every request verified. No kernel is launched;
8. the LM substrate (``lm_phase``; no kernel of ``csrc/`` runs, as no
   Pallas kernel runs in the reference's LM): qwen2-1.5b and zamba2-2.7b
   whole and grok-1-314b at full width with its depth cut (``LM_MODELS``),
   random weights from a ``torch.Generator`` on the card (seed 0), tokens
   from ``data.pipeline.synthetic_batch``. Per model, with TF32 off: a
   float32 prefill of 4 x 1024 and 16 teacher-forced decode steps, the last
   held to a prefill of all 1040 tokens (relative max error <= 2e-3), a
   17th step into the full cache must raise; the same weights at depth 1
   (zamba2: one segment) on the card and on the CPU within ``LM_CPU_REL``;
   a bf16 prefill (timed: ms, tokens/s, MFU) and 32 greedy decode steps
   (ms per step beside the byte bound), every logit finite, the top-1
   agreement with float32 and the peak memory. Then
   ``F.scaled_dot_product_attention`` timed beside the port's
   ``flash_attention`` at qwen2's prefill shape (a yardstick the port never
   calls) and ``data.packing.pack_documents`` on the card over 20000
   documents, equal to its CPU run, no bin over 2048, fill efficiency
   > 0.7, its docs/s and ``block_rmq`` builds;
9. LM training (``train_phase``; no kernel of ``csrc/`` runs, as no Pallas
   kernel runs in the reference's training): (a) qwen2-1.5b whole (28
   layers, 1,543,852,032 parameters), bf16 params with the float32 AdamW
   master, 8 steps of 4 x 1024 on one fixed batch at lr 3e-4 (cosine,
   warmup 2), remat as the config sets it: the loss must fall; step ms
   (median of steps 3-8), tokens/s, MFU (6 N tokens per step over 989
   TFLOP/s), the AdamW update alone against its byte bound, the peak
   memory, a profiled step; (b) the same draws at depth 1 in float32, one
   step of 1 x 128 on the card and on the CPU, every gradient and updated
   master leaf within ``TRAIN_CPU_REL``; then in bf16, the loss and grad
   norm within ``TRAIN_BF16_LOSS_REL``, the gradients within
   ``TRAIN_BF16_GRAD_REL``, the master within 2 lr, the new params the
   master cast to bf16; (c) ``train.runner.run_training``
   at full width with the depth cut to 2, 8 steps, a checkpoint every 4, a
   fault at step 5: one restart, the last checkpoint restored equal to the
   live state bit for bit, a checkpoint's seconds and bytes (under
   ``build/train_ckpt``, deleted at the end); (d) ``python -m
   repro_torch.launch.train --arch granite-3-8b --smoke --steps 8`` on the
   card; (e) reduced grok-1-314b on a (2, 4) mesh of the card (two MoE
   groups): 3 steps, the losses equal to the same on the CPU within 1e-5;
10. the dry run (``dryrun_phase``; ``launch/dryrun.py`` on the ``meta``
   device, in worker processes that never initialise CUDA): (a)
   ``run_cell`` on the 16 x 16 mesh for qwen2-1.5b, zamba2-2.7b and
   grok-1-314b at every shape ``configs.cells()`` gives them, and one
   ``--compile-only`` cell on the 2 x 16 x 16 mesh, each record's terms,
   bottleneck and useful ratio printed (computed for 256 and 512 H100s,
   not measured); (b) the roofline floor of phase 9 (a)'s step: qwen2-1.5b
   whole at 4 x 1024 on a one-position meta mesh, its dtypes and remat:
   the measured step must be at least ``max(t_compute, t_memory)``, and
   arg + temp bytes are printed beside the measured peak; (c) the phase
   within ``DRYRUN_SECONDS``;
11. one JSON ``kernels`` line, the wall time, the card line again, and the
   last line ``{"ok": true, "device": {...}}``;
12. LM training on a mesh of ranks (``ranks_phase``; it runs after phase
   10, before phase 11's closing lines): ``torch.cuda.device_count()``
   ranks (one on a one-card machine), spawned with NCCL, build the
   ``(1, n)`` ``("data", "model")`` mesh of ranks and train qwen2-1.5b
   whole (bf16 params, float32 master) through ``make_train_step`` on
   DTensor leaves: ``RANKS_STEPS`` steps of phase 9 (a)'s batch and
   schedule from its seed-0 params. Each loss must equal phase 9 (a)'s at
   that step within ``RANKS_LOSS_REL``; printed: step ms (CUDA events),
   the losses, ``max_memory_allocated`` per rank beside phase 9 (a)'s, and
   the ranks and devices.

Times are medians of CUDA-event timings (ms); kernel ms is the device time
``torch.profiler`` reports, warm (``ms``: the same batch launched again and
again, so it sits in L2) and cold (``cold_ms``: a 128 MiB write between
launches evicts L2, as fresh ranges over a large array find it).
``bound_ms`` is the larger of the bytes the call must move over 3.35 TB/s
and its operations over the card's peak (67 TFLOP/s float32 outside the
tensor cores; tiny here), from this run's inputs. Tolerance of every
comparison: exact.
"""

from __future__ import annotations

import ast
import contextlib
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.launch.roofline import HW  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FLUSH_BYTES = 128 << 20  # written between cold launches: 2.5 times the 50 MB L2
N_MAIN = 1 << 26  # the served array: 2^26 float32 values
N_RESIDENT = 1 << 20  # nb = 2^13 blocks of 128: both fetches timed and served here
EULER_HEIGHT = 24  # Euler tour of a complete binary tree: n = 2^26 - 3
N_LONG = 10**8  # the benchmark cell's array: sparse_query's row (a 28-level table, 11.2 GB)
SPARSE_BYTES_PER_QUERY = 8 + 4 * 32 + 8  # bounds, four random 32-byte sectors, answers
# Phase 7f's array: three replicas each hold a whole structure, and an online
# hybrid at 2^26 peaks at 16.2 GB and repairs each batch on the host for 5-9 s.
N_FLEET = 1 << 24
# Phase 7b's routing threshold: about the median `small` length at n = 2^26
# (n^0.3 = 222), so the online hybrid's blocked path and its sparse table
# each take part of every launch.
ONLINE_THRESHOLD = 224
# Phase 8, the LM substrate: (arch, float32 depth, bf16 depth, float32
# overrides); a depth of None keeps the whole model. grok-1-314b needs about
# 630 GB in bf16: 2 of its 64 layers fit the card in bf16 (about 23 GB), 1 in
# float32 (about 26 GB).
LM_MODELS = (
    ("qwen2-1.5b", None, None, {}),
    ("zamba2-2.7b", None, None, {}),
    ("grok-1-314b", 1, 2, {"capacity_factor": 4.0}),
)
LM_BATCH, LM_PROMPT = 4, 1024  # the prefill: B x L tokens
LM_CHECK_STEPS = 16  # float32 teacher-forced decode steps held to a full prefill
LM_SERVE_STEPS = 32  # bf16 greedy decode steps
LM_CPU_TOKENS = 64  # the CUDA-vs-CPU prompt (1 x 64), then two decode steps
# float32 on both, one layer (segment): only the order of the sums differs;
# the bound the CPU tests hold the port to against the reference
LM_CPU_REL = 1e-4
# bf16 against float32 on the same draws, the prefill's last logits: bf16's
# rounding (2^-8 a step) carried through every layer. Measured on the H100:
# 2.0e-2 (qwen2), 3.5e-2 (zamba2), 1.4e-2 (grok, 1 layer); about three times
# the largest.
LM_BF16_REL = 0.1
LM_PACK_DOCS, LM_PACK_SEQ = 20000, 2048
# H100 SXM dense bf16 peak (data sheet): the dry run's roofline constant
BF16_FLOPS = HW["peak_flops"]
# Phase 9, LM training: the whole model's steps (bf16 params, float32 master)
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 8, 3e-4, 2
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 1, 128  # (b): one step on the card and on the CPU
# float32 on both, one layer: only the order of the sums differs; the bound
# the CPU tests hold the port to against the reference
TRAIN_CPU_REL = 1e-4
TRAIN_CONDITIONED = 1e-2  # (b): a gradient at least this fraction of its leaf's largest
# (b) in bf16 (params, activations, gradients; float32 master): the two
# devices' bf16 ops round differently. Measured on the H100: loss 2.3e-5,
# grad norm 4.3e-5, gradients 1.2e-2; the bounds are about 4 times that.
TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL = 2e-4, 5e-2
TRAIN_RUNNER_DEPTH, TRAIN_FAULT_STEP = 2, 5  # (c): the whole model's checkpoints would be 25 GB each
TRAIN_MESH_REL = 1e-5  # (e): the losses, float32
# Phase 12, training on a mesh of ranks: phase 9 (a)'s first steps again;
# each loss held to phase 9's within the bf16 loss bound of
# tests/test_torch_train_parity.py (BF16_LOSS)
RANKS_STEPS = 3
RANKS_LOSS_REL = 1e-4
# Phase 10, the dry run: its archs (every shape cells() gives each), the
# 2 x 16 x 16 mesh's compile-only cell, and the phase's time limit
DRYRUN_ARCHS = ("qwen2-1.5b", "zamba2-2.7b", "grok-1-314b")
DRYRUN_MULTI = ("qwen2-1.5b", "train_4k")
DRYRUN_SECONDS = 120.0


def _disk_free(path) -> int:
    """Prints the filesystem under ``path`` (``df -T``) and its free bytes
    (``os.statvfs``); returns the free bytes."""
    st = os.statvfs(path)
    free = st.f_bavail * st.f_frsize
    df = subprocess.run(["df", "-T", str(path)], capture_output=True, text=True)
    fs = " ".join(df.stdout.strip().splitlines()[-1].split()) if df.returncode == 0 else df.stderr.strip()
    print(f"[disk] {path}: {free} bytes free (statvfs); df -T: {fs}")
    return free


def _hybrid_snapshot_bytes(n: int, bs: int = 128) -> int:
    """The leaves of an online hybrid's checkpoint at n float32 values: x,
    the full-array table (floor(log2 n) + 1 levels), and the blocked
    leaves (values, block minima and their indices, the block table)."""
    nb = -(-n // bs)
    return 4 * (n + n.bit_length() * n + nb * bs + 2 * nb + nb.bit_length() * nb)


def _chaos_faults(summary: str) -> tuple:
    """(injected apply failures, recoveries, failed checkpoints) of a chaos
    soak's summary line."""
    m = re.search(r"\((\d+) injected apply failures -> (\d+) recoveries\), (\d+) failed checkpoints", summary)
    _require(m is not None, f"not a chaos summary: {summary}")
    return tuple(int(g) for g in m.groups())


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    import numpy as np

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _kernel_ms(torch, fn, name: str, iters: int = 20, attempts: int = 5, flush=None) -> float:
    """Device time of one launch of the kernel whose name holds ``name``,
    from ``torch.profiler`` (mean over ``iters`` launches). With ``flush``
    (a tensor of ``FLUSH_BYTES`` on the card) every launch follows a write
    of the whole tensor, which evicts L2: the kernel finds its inputs in
    device memory, as a served batch of fresh ranges does. The write is a
    kernel of its own and is not counted. A session that records no such
    kernel (it happens now and then) is run again; after ``attempts`` empty
    sessions the run fails: a kernel's row never holds another time than
    its device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                if flush is not None:
                    flush.fill_(i)
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if name in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(e.self_device_time_total for e in hits) / count / 1e3
        print(f"[profiler] no {name} kernel recorded in a session of {iters} calls; again")
    raise SystemExit(f"chip_smoke: FAILED: torch.profiler recorded no {name} kernel")


def all_kernels_ms(torch, fn, iters: int = 10) -> float:
    """Device time of one ``fn()`` in ms over every kernel it launches (a
    chain of torch ops), from ``torch.profiler``: the mean over ``iters``
    calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / iters / 1e3


def kernel_times(torch, fn, name: str, flush) -> dict:
    """A kernel's device time warm (``ms``: the same batch launched again and
    again, so from the second launch on its rows and cells sit in L2) and
    cold (``cold_ms``: L2 flushed before every launch), and ``call_ms``, the
    CUDA-event median of one wrapper call (host work included)."""
    return dict(
        ms=_kernel_ms(torch, fn, name),
        cold_ms=_kernel_ms(torch, fn, name, flush=flush),
        call_ms=_time_ms(torch, fn),
    )


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _max_abs_err(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0


def _queries(rng, n: int, b: int, max_len: int = 8192):
    """Lengths uniform in [1, max_len], plus a full-range and two l == r queries."""
    import numpy as np

    length = rng.integers(1, min(max_len, n) + 1, b)
    l = rng.integers(0, n - length + 1)
    r = l + length - 1
    l[:3] = [0, 7, n - 1]
    r[:3] = [n - 1, 7, n - 1]
    return l.astype(np.int32), r.astype(np.int32)


def _fq_bytes(l, r, bs: int, itemsize: int, fetch: str) -> int:
    """Bytes one fused_query call must move for these queries: the elements
    of each partial range, the interior cells, the bounds and the outputs."""
    import numpy as np

    l = l.astype(np.int64)
    r = r.astype(np.int64)
    bl, br = l // bs, r // bs
    ls, re = l - bl * bs, r - br * bs
    le = np.where(bl == br, re, bs - 1)
    elems = (le - ls + 1) + np.where(br > bl, re + 1, 0)
    cell = 2 * (itemsize + 4) if fetch == "dma" else 2 * 4 + 2 * (itemsize + 4)
    hasint = (br - bl) >= 2
    return int(elems.sum() * itemsize + hasint.sum() * cell + l.size * (8 + 4 + itemsize))


def _packed_bytes(l, r, bs: int, itemsize: int, layout: str) -> int:
    """Bytes one fused_query_packed call must move: the words (packed32: 4
    bytes, packed64: 8) or values (quantized) of each partial range, the
    interior cells (two words; quantized also their two block minima), the
    bounds and the outputs."""
    import numpy as np

    l = l.astype(np.int64)
    r = r.astype(np.int64)
    bl, br = l // bs, r // bs
    ls, re = l - bl * bs, r - br * bs
    le = np.where(bl == br, re, bs - 1)
    elems = (le - ls + 1) + np.where(br > bl, re + 1, 0)
    word = {"packed32": 4, "packed64": 8}.get(layout, itemsize)
    cell = 2 * (8 if layout == "packed64" else 4) + (2 * itemsize if layout == "quantized" else 0)
    hasint = (br - bl) >= 2
    return int(elems.sum() * word + hasint.sum() * cell + l.size * (8 + 4 + itemsize))


def _partials_bytes(l, r, bs: int, itemsize: int) -> int:
    """Bytes one rmq_partials call must move: the elements of each partial
    range, five int32 bounds per query, and the (value, index) outputs."""
    import numpy as np

    l = l.astype(np.int64)
    r = r.astype(np.int64)
    bl, br = l // bs, r // bs
    ls, re = l - bl * bs, r - br * bs
    le = np.where(bl == br, re, bs - 1)
    elems = (le - ls + 1) + np.where(br > bl, re + 1, 0)
    return int(elems.sum() * itemsize + l.size * (20 + 4 + itemsize))


def _lane_bytes(l, r, itemsize: int) -> int:
    """Bytes one lane_partials call must move: a same-block query's masked
    elements, a straddling one's suffix and prefix cells (value + index),
    four int32 bounds per query, and the outputs."""
    import numpy as np

    l = l.astype(np.int64)
    r = r.astype(np.int64)
    same = (l // 128) == (r // 128)
    elems = np.where(same, (r - l + 1) * itemsize, 2 * (itemsize + 4))
    return int(elems.sum() + l.size * (16 + 4 + itemsize))


def euler_depths(height: int):
    """Depths along the Euler tour of a complete binary tree of ``height``:
    E(0) = [0], E(h) = [0] + (E(h-1) + 1) + [0] + (E(h-1) + 1) + [0];
    length 2^(height+2) - 3, int32, adjacent entries differ by one."""
    import numpy as np

    e = np.zeros(1, np.int32)
    zero = np.zeros(1, np.int32)
    for _ in range(height):
        e = np.concatenate([zero, e + 1, zero, e + 1, zero])
    return e


def _leaves(s, path="s"):
    """[(path, tensor)] of every tensor leaf of a NamedTuple state, depth
    first in field order (configs, closures and ints skipped)."""
    import torch

    if isinstance(s, torch.Tensor):
        return [(path, s)]
    if isinstance(s, tuple):
        names = getattr(s, "_fields", None) or [f"[{i}]" for i in range(len(s))]
        return [leaf for name, v in zip(names, s) for leaf in _leaves(v, f"{path}.{name}")]
    return []


def _device_busy_share(torch, np, dev) -> None:
    """The async hybrid ``small`` run again, its client window traced with
    ``torch.profiler`` (device activity only): the device's busy and idle
    share of the window, and its busiest kernels. The profiler slows the
    host, so this run reports no latency."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import build as build_mod
    from repro_torch.core import registry
    from repro_torch.serve import RMQServer, ServeConfig
    from repro_torch.serve.workload import make_queries, run_poisson_clients

    x = np.random.default_rng(0).random(N_MAIN, dtype=np.float32)
    plan = registry.plan_for_serving("hybrid", N_MAIN, dev)
    state = build_mod.execute(plan, x)
    spec = registry.get("hybrid")
    srv = RMQServer(
        lambda l, r: spec.query(state, l, r),
        ServeConfig(n=N_MAIN),
        warmup_bounds=build_mod.warmup_bounds(plan),
    )
    srv.warmup()
    with srv, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        per_client = run_poisson_clients(
            4, 32, 200.0, lambda rng, c: make_queries(rng, N_MAIN, 256, "small"), srv.submit,
            seed=10_000,
        )
        for out in per_client:
            for _, fut in out:
                _require(fut is not None and fut.result(timeout=300).idx.size == 256, "traced run")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    print(
        f"[trace] async hybrid small, n={N_MAIN}: device busy {busy_us / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms client window (busy share {busy_us / wall_us:.4f}, "
        f"idle share {1 - busy_us / wall_us:.4f}; {srv.stats().n_batches} launches)"
    )
    for e in events[:6]:
        print(f"[trace]   {e.self_device_time_total / 1e3:.3f} ms in {e.count} x {e.key[:90]}")


def _traced(torch, fn):
    """``fn()`` under ``torch.profiler`` (device activity only): ``(result,
    device busy ms, window ms)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return out, busy_ms, wall_ms


def mesh_phase(torch, np, dev, drive, check) -> None:
    """Phase 7d: the mesh engines at n = 2^26 on a (2, 4) mesh of 8 shards
    on one card (and an (8,) mesh for ``distributed``), one engine at a time.

    Each engine: build, structure checks, 4096 `small` and 4096 `medium`
    queries, ``edge_batch``'s adversarial batches and the maxval-only
    inputs, every index equal to the single-device ``hybrid``'s and to the
    oracle; the ``sharded_hybrid`` modes are also served async; then
    ``calibrate(mesh=)`` and the serve CLI's mesh engines on the card's
    default mesh. The mesh engines launch no CUDA kernel (the reference's
    run no Pallas kernel): each run is driven with ``none``."""
    import gc

    from repro_torch.core import block_rmq, distributed, hybrid, ref, registry, sharded_hybrid, sparse_table
    from repro_torch.core import build as build_mod
    from repro_torch.kernels.edge_batch import edge_batch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import RMQServer, ServeConfig
    from repro_torch.serve.workload import make_queries, run_poisson_clients

    t_phase = time.perf_counter()
    x = np.random.default_rng(0).random(N_MAIN, dtype=np.float32)  # phases 1-6's array
    euler = euler_depths(EULER_HEIGHT)
    mesh24 = make_mesh((2, 4), ("data", "model"))  # round-robin over the visible cards
    mesh8 = make_mesh((8,), ("shard",))
    print(f"[mesh] {mesh24!r}; {mesh8!r}")

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # Query sets, their oracle and the single-device hybrid's indices, once
    # (the hybrid runs the fused kernel: outside the mesh runs' counts).
    qrng = np.random.default_rng(21)
    inputs = {"main": x, "euler": euler}
    for dtype in ("float32", "int32"):
        xe, le, re_ = edge_batch(128, dtype, 4099)
        inputs[f"edge {dtype}"] = xe
    inputs["maxval float32"] = np.array([0.0, np.inf, np.inf], np.float32)
    inputs["maxval int32"] = np.array([5, 2**31 - 1, 2**31 - 1], np.int32)
    qsets = {}
    for name, arr in inputs.items():
        if name in ("main", "euler"):
            sets = [(dist, *make_queries(qrng, arr.size, 4096, dist)) for dist in ("small", "medium")]
        elif name.startswith("edge"):
            sets = [("edge", *edge_batch(128, name.split()[1], 4099)[1:])]
        else:
            sets = [("maxval", np.array([1, 2, 1], np.int32), np.array([2, 2, 1], np.int32))]
        hyb = registry.build_for_serving("hybrid", arr, device=dev)
        qsets[name] = [
            (dist, l, r, ref.rmq_ref(arr, l, r), hybrid.query(hyb, l, r)[0].cpu().numpy()) for dist, l, r in sets
        ]
        del hyb
    fresh()
    print(f"[mesh] query sets, oracle and single-device hybrid ready in {time.perf_counter() - t_phase:.1f} s")

    def answer(label, query, state, name, timed=False):
        """Every query set of input ``name``: indices equal to the oracle and
        to the single-device hybrid, values to x[gold]; with ``timed`` the
        median ms per 4096-query batch over 5 repeats."""
        arr = inputs[name]
        for dist, l, r, gold, hyb in qsets[name]:
            times = []
            for _ in range(6 if timed else 1):
                t0 = time.perf_counter()
                idx, val = query(state, l, r)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            got = idx.cpu().numpy()
            _require(bool((got == hyb).all()), f"{label} {name} {dist}: indices differ from the single-device hybrid")
            check(f"{label} {name} {dist}", arr, l, r, idx, val)
            if timed:
                print(f"[mesh]   {label} {dist}: {np.median(times[1:]) * 1e3:.3f} ms per batch of {l.size} "
                      f"(median of 5), {l.size}/{l.size} equal to the oracle and the hybrid")

    def small_inputs(label, build):
        """The edge batches and maxval-only inputs through ``build(arr)``."""
        for name in ("edge float32", "edge int32", "maxval float32", "maxval int32"):
            state, query = build(inputs[name])
            answer(label, query, state, name)

    def check_structure(label, state, struct_shards):
        """The sharded doubling table's global view equals ``sparse_table.build``
        of the padded array (and its values x[idx]); each shard's blocked
        leaves equal ``block_rmq.build`` of its chunk."""
        xd = torch.from_numpy(x).to(dev)
        want = sparse_table.build(xd)
        if struct_shards:
            idx = state.st.idx.full()
            _require(torch.equal(idx, want.idx), f"{label}: st.idx != sparse_table.build")
            del idx
            val = state.st.val.full()
            _require(torch.equal(val.view(torch.int32), xd[want.idx].view(torch.int32)), f"{label}: st.val != x[idx]")
            del val
        else:
            _require(torch.equal(state.st.idx.full(), want.idx), f"{label}: replicated st.idx != sparse_table.build")
        del want
        num = max(struct_shards, 1)
        shard_len = N_MAIN // num
        for s in range(num):
            built = block_rmq.build(xd[s * shard_len:(s + 1) * shard_len], 128, device=dev)
            for (path, a), (_, b) in zip(_leaves(distributed.shard(state.blocked, s)), _leaves(built)):
                _require(torch.equal(a, b), f"{label}: shard {s} {path} != block_rmq.build of its chunk")
        print(f"[mesh]   {label}: sharded table == sparse_table.build, {num} blocked shard(s) == block_rmq.build")

    gold_cache = {}

    def served(label, state, dist, traced=False):
        """4 clients x 32 requests x 256 queries at 200/s through RMQServer;
        every request held to the oracle in one batched check."""
        spec = registry.get("sharded_hybrid")
        srv = RMQServer(lambda l, r: spec.query(state, l, r), ServeConfig(n=N_MAIN))
        srv.warmup()

        def run():
            with srv:
                per_client = run_poisson_clients(
                    4, 32, 200.0, lambda rng, c: make_queries(rng, N_MAIN, 256, dist), srv.submit, seed=10_000
                )
                return [(l, r, fut.result(timeout=300)) for out in per_client for (l, r), fut in out]

        if traced:
            _, busy, wall = _traced(torch, run)
            print(f"[mesh]   {label} served {dist} (traced): device busy {busy:.3f} ms of {wall:.3f} ms "
                  f"(idle share {1 - busy / wall:.4f})")
            return
        done = run()
        l, r = (np.concatenate([d[i] for d in done]) for i in (0, 1))
        key = (dist, l.tobytes(), r.tobytes())
        if key not in gold_cache:
            gold_cache[key] = ref.rmq_ref(x, l, r)
        gold = gold_cache[key]
        idx = np.concatenate([d[2].idx for d in done])
        val = np.concatenate([d[2].val for d in done])
        _require(bool((idx == gold).all() and (val == x[gold]).all()), f"{label} served {dist} != oracle")
        st = srv.stats()
        print(f"[mesh]   {label} served {dist}: {len(done)} requests x 256, all equal to the oracle; "
              f"p50 {st.p50_total_s * 1e3:.2f} ms p99 {st.p99_total_s * 1e3:.2f} ms, {st.n_batches} launches")

    peaks = {}
    for mode in sharded_hybrid.MODES:
        def sharded_mode(mode=mode):
            label = f"sharded_hybrid {mode}"
            fresh()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            state = registry.build_for_serving("sharded_hybrid", x, mesh=mesh24, mode=mode)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            peaks[mode] = torch.cuda.max_memory_allocated()
            print(f"[mesh] {label} on {mesh24!r}: build {t_build:.2f} s, threshold {state.threshold}, "
                  f"max_memory_allocated {peaks[mode]} bytes (build; {held} bytes held before it)")
            struct = {"shard_structure": 8, "shard_batch": 0, "shard_2d": 2}[mode]
            check_structure(label, state, struct)
            answer(label, sharded_hybrid.query, state, "main", timed=True)
            for dist in ("small", "medium"):
                served(label, state, dist)
            served(label, state, "small", traced=True)
            print(f"[mesh]   {label}: max_memory_allocated {torch.cuda.max_memory_allocated()} bytes (build, checks, serving)")
            del state
            fresh()
            small_inputs(label, lambda arr: (registry.build_for_serving("sharded_hybrid", arr, mesh=mesh24, mode=mode),
                                             sharded_hybrid.query))
        drive(f"sharded_hybrid {mode} on 8 shards, 2^26", sharded_mode, none=True)
    for mode in ("shard_batch", "shard_2d"):
        _require(peaks[mode] <= 1.1 * peaks["shard_structure"],
                 f"{mode} peak {peaks[mode]} B exceeds 1.1 x shard_structure's {peaks['shard_structure']} B")
    print(f"[mesh] build peaks (bytes): {json.dumps(peaks)}; replicas share one copy per card")

    def one_engine(label, engine, arr_name, mesh, **kw):
        def run():
            fresh()
            t0 = time.perf_counter()
            state = registry.build_for_serving(engine, inputs[arr_name], mesh=mesh, **kw)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            pspec = registry.packed_spec(state)
            print(f"[mesh] {label}: build {t_build:.2f} s, layout {pspec.layout if pspec else 'unpacked'}, "
                  f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
            query = registry.get(engine).query
            answer(label, query, state, arr_name, timed=True)
            sets = [(l, r) for _, l, r, *_ in qsets[arr_name]]
            _, busy, wall = _traced(torch, lambda: [query(state, l, r) for _ in range(5) for l, r in sets])
            print(f"[mesh]   {label} 5 x small + medium batches (traced): device busy {busy:.3f} ms of "
                  f"{wall:.3f} ms (idle share {1 - busy / wall:.4f})")
            del state
            if arr_name == "main":
                fresh()
                small_inputs(label, lambda arr: (registry.build_for_serving(engine, arr, mesh=mesh, **kw),
                                                 registry.get(engine).query))
            return pspec
        return run

    drive("distributed bs 1024 on 8 shards, 2^26", one_engine("distributed (8,) bs 1024", "distributed", "main", mesh8),
          none=True)
    drive("packed_sharded_hybrid auto on 8 shards, 2^26",
          one_engine("packed_sharded_hybrid auto", "packed_sharded_hybrid", "main", mesh24), none=True)
    drive("packed_sharded_hybrid packed32 Euler on 8 shards",
          one_engine("packed_sharded_hybrid packed32 Euler", "packed_sharded_hybrid", "euler", mesh24,
                     packed="packed32"), none=True)

    def calibrate_mesh():
        for mode in ("shard_structure", "shard_2d"):
            fresh()
            t0 = time.perf_counter()
            thr = hybrid.calibrate(N_MAIN, mesh=mesh24, mode=mode)
            print(f"[mesh] calibrate(2^26, mesh=(2, 4), mode={mode}) = {thr} "
                  f"(sqrt(n) = {round(N_MAIN ** 0.5)}) in {time.perf_counter() - t0:.1f} s")

    drive("calibrate(mesh=) 2^26", calibrate_mesh, none=True)

    def mesh_cli():
        asy = ["--mode", "async", "--clients", "4", "--requests", "32", "--req-batch", "256", "--n", str(N_MAIN)]
        for argv in (["--engine", "sharded_hybrid", "--qshard", "2d", *asy],
                     ["--engine", "distributed", "--mode", "oneshot", "--batch", "4096", "--n", str(N_MAIN)]):
            fresh()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                serve.main(argv)
            text = buf.getvalue()
            print(text, end="")
            _require("verify: 128/128 requests bit-identical" in text or "verify[64] OK" in text,
                     f"the CLI {argv[:4]} did not verify")
            _require("on 1 shard(s) on 1 device(s)" in text, "the CLI's default mesh is not one shard on the card")

    drive("serve CLI mesh engines 2^26", mesh_cli, none=True)
    fresh()
    print(f"[phase] mesh engines took {time.perf_counter() - t_phase:.1f} s")


def _mesh_leaves(tree):
    """[(path, ShardedLeaf)] of a mesh structure, depth first in field order."""
    out = []

    def walk(t, path):
        if hasattr(t, "copies"):  # core.distributed.ShardedLeaf
            out.append((path, t))
        elif isinstance(t, tuple):
            for i, v in enumerate(t):
                walk(v, f"{path}.{getattr(t, '_fields', range(len(t)))[i]}")

    walk(tree, "s")
    return out


def _same_mesh_leaves(torch, want, got, label: str) -> None:
    """Two mesh structures equal leaf for leaf and shard for shard, dtypes
    included, values bit for bit (compared on the card, shard by shard)."""
    a, b = _mesh_leaves(want), _mesh_leaves(got)
    _require([p for p, _ in a] == [p for p, _ in b] and a, f"{label}: leaf paths differ")
    for (path, x), (_, y) in zip(a, b):
        _require(x.dtype == y.dtype and x.shape == y.shape and x.num_shards == y.num_shards,
                 f"{label}: {path} is {y.dtype} {y.shape}, a fresh build's is {x.dtype} {x.shape}")
        for s in range(x.num_shards):
            p, q = x.part(s), y.part(s)
            if p.dtype == torch.float32:
                p, q = p.view(torch.int32), q.view(torch.int32)
            _require(torch.equal(p, q), f"{label}: {path} shard {s} differs from a fresh build")


def mesh_online_phase(torch, np, dev, drive, check, root) -> None:
    """Phase 7e: online and durable mesh engines at n = 2^26 - 71 on 8 shards
    of one card, one engine at a time.

    Each engine goes online (``update.make_online(mesh=)``) and takes the
    reference child's four logs scaled to n: a leftmost tie across the
    shard boundary at 2^25, a fill over shards 0-2, an append inside the
    padded capacity (as many values as fit, at most 50) and one of 9000
    past it (a rebuild, ``patched=False``; ``shard_batch``'s host mirrors
    grow and patch instead). After each log 4096 `small` and 4096 `medium`
    queries are held to the oracle of that version; after the last patch
    and at the end the leaves equal a from-scratch build of the mutated
    array. Per apply: ms, ``patched``, device operations (kernels and
    copies, from ``torch.profiler``) and peak bytes. Then ``DurableEngine``
    on the (8,) mesh: three logs, a checkpoint after the first, a restore
    that replays two and equals the live leaves."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import update
    from repro_torch.core import build as build_mod
    from repro_torch.core import distributed
    from repro_torch.fault import DurableEngine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.workload import make_queries

    t_phase = time.perf_counter()
    n = N_MAIN - 71  # odd: every structure keeps at least one padded column
    x = np.random.default_rng(0).random(n, dtype=np.float32)
    euler = euler_depths(EULER_HEIGHT)
    mesh24 = make_mesh((2, 4), ("data", "model"))
    mesh8 = make_mesh((8,), ("shard",))
    print(f"[mesh-online] n = {n} (2^26 - 71) float32 and the Euler depths (n = {euler.size}); {mesh24!r}; {mesh8!r}")

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def room(name, state, n_now):
        """Values an append may add inside the padded capacity (the
        engines' own rule); shard_batch's mirrors grow: unbounded."""
        if name == "distributed":
            nb, bs = state[0].x_blocks.shape
            return nb * bs - n_now
        if state.mode == "shard_batch":
            return 1 << 30
        blocked = state.blocked.blocks if state.spec is not None else state.blocked.x_blocks
        cols = state.st.words.shape[1] if state.spec is not None else state.st.idx.shape[1]
        return min(blocked.shape[0] * blocked.shape[1], cols) - n_now

    def state_spec(state):
        return getattr(state, "spec", None)

    def shard_cols(name, state):
        """Columns per structure shard of the sparse table (distributed:
        of the blocked chunk; shard_batch, whose structures are whole on
        every position: an eighth of n)."""
        if name == "distributed":
            return state[0].x_blocks.part(0).numel()
        if state.mode == "shard_batch":
            return -(-state.n // 8)
        return (state.st.words if state.spec is not None else state.st.idx).part(0).shape[-1]

    def logs(x0, state, name, rng):
        int_data = x0.dtype == np.int32
        tie, fill = (0, 1) if int_data else (-7.0, 0.25)
        k = min(50, room(name, state, x0.size))
        c = shard_cols(name, state)
        tail = lambda m: (rng.integers(0, 2, m).astype(np.int32) if int_data else rng.random(m, dtype=np.float32))
        out = [(f"tie across the shard boundary at column {c}", update.DeltaLog().point(c - 1, tie).point(c, tie)),
               ("fill over shards 0-2", update.DeltaLog().fill(c - c // 8, min(2 * c + c // 8, x0.size - 1), fill))]
        out.append((f"append {k} inside the capacity", update.DeltaLog().append(tail(k))) if k > 0 else None)
        if state_spec(state) is not None and state.spec.layout == "packed32" and x0.size + 9000 > (1 << 26):
            # Past 2^26 the index field takes 27 bits and this key span 5
            # more: no packed32 spec holds it, and the rebuild raises (in
            # the reference too; tests/test_torch_sharded_hybrid.py pins it).
            print(f"[mesh-online] packed32: no append past the capacity (n > 2^26 needs 27 index bits "
                  f"beside a {state.spec.val_bits}-bit key field's span)")
        else:
            out.append(("append 9000 past the capacity", update.DeltaLog().append(tail(9000))))
        return [o for o in out if o is not None]

    def fresh_build(name, online, xm, mesh, kw):
        st = online.store.current.state
        if name == "distributed":
            plan = build_mod.plan_for("distributed", xm.size, mesh=mesh, axis_names=mesh.axis_names,
                                      block_size=kw["block_size"])
            return build_mod.execute(plan, xm)[0], st[0]
        if st.spec is not None:  # under the engine's spec, which patches keep
            axes = mesh.axis_names
            return ((distributed.build_sharded_packed(xm, mesh, axes, 128, st.spec),
                     distributed.build_sharded_st_packed(xm, mesh, axes, st.spec)), (st.blocked, st.st))
        plan = build_mod.plan_for("sharded_hybrid", xm.size, mesh=mesh, axis_names=mesh.axis_names, block_size=128,
                                  threshold=int(st.threshold), mode=kw["mode"])
        f = build_mod.execute(plan, xm)
        return (f.blocked, f.st), (st.blocked, st.st)

    def online_engine(label, name, mesh, kw, x0):
        def run():
            fresh()
            t0 = time.perf_counter()
            eng = update.make_online(name, x0, mesh=mesh, axis_names=mesh.axis_names, **kw)
            print(f"[mesh-online] {label}: online build {time.perf_counter() - t0:.2f} s, "
                  f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
            xm = x0.copy()
            qrng = np.random.default_rng(22)
            sched = logs(x0, eng.store.current.state, name, np.random.default_rng(23))
            for i, (what, log) in enumerate(sched):
                torch.cuda.reset_peak_memory_stats()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    res = eng.apply(log)
                events = prof.key_averages()
                ops = sum(e.count for e in events)
                busy = sum(e.self_device_time_total for e in events) / 1e3
                xm = log.coalesce(xm.size, xm.dtype).apply_numpy(xm)
                print(f"[mesh-online]   {label} {what}: {'patched' if res.patched else 'rebuilt'} in "
                      f"{res.seconds * 1e3:.1f} ms (device busy {busy:.2f} ms), {ops} device ops "
                      f"(kernels and copies), {res.touched_shards} touched shard(s), max_memory_allocated "
                      f"{torch.cuda.max_memory_allocated()} B")
                if what.startswith("append 9000"):
                    mirrors = kw.get("mode") == "shard_batch"  # host mirrors grow: a patch
                    _require(res.patched == mirrors, f"{label}: {what} reported patched={res.patched}")
                else:
                    _require(res.patched, f"{label}: {what} did not patch")
                sets = [make_queries(qrng, xm.size, 4096, dist) for dist in ("small", "medium")]
                l, r = (np.concatenate(a) for a in zip(*sets))
                ver = eng.pin()
                try:
                    idx, val = eng.query(ver.state, l, r)
                finally:
                    eng.release(ver.vid)
                check(f"{label} v{ver.vid} small + medium", xm, l, r, idx, val)
                if i >= len(sched) - 2:  # the last patch, then the end
                    want, got = fresh_build(name, eng, xm, mesh, kw)
                    _same_mesh_leaves(torch, want, got, f"{label} after {what}")
                    del want, got
            print(f"[mesh-online]   {label}: every version's 8192 queries equal to its oracle; the last patch "
                  f"and the final state equal a fresh build leaf for leaf")
            del eng
            fresh()
        return run

    runs = [
        ("sharded_hybrid shard_structure (2, 4)", "sharded_hybrid", mesh24, {"mode": "shard_structure"}, x),
        ("sharded_hybrid shard_batch (2, 4)", "sharded_hybrid", mesh24, {"mode": "shard_batch"}, x),
        ("sharded_hybrid shard_2d (2, 4)", "sharded_hybrid", mesh24, {"mode": "shard_2d"}, x),
        ("distributed bs 1024 (8,)", "distributed", mesh8, {"block_size": 1024}, x),
        ("packed_sharded_hybrid packed32 Euler (2, 4)", "packed_sharded_hybrid", mesh24, {"packed": "packed32"}, euler),
    ]
    for label, name, mesh, kw, x0 in runs:
        drive(f"online {label}", online_engine(label, name, mesh, kw, x0), none=True)

    durable_dir = root / "build" / "durable"
    shutil.rmtree(durable_dir, ignore_errors=True)
    durable_dir.mkdir(parents=True)

    def durable_mesh():
        for label, name, kw in (("sharded_hybrid shard_structure", "sharded_hybrid", {"mode": "shard_structure"}),
                                ("distributed bs 1024", "distributed", {"block_size": 1024})):
            fresh()
            d_root = durable_dir / name
            t0 = time.perf_counter()
            d = DurableEngine.create(name, x, str(d_root), mesh=mesh8, axis_names=mesh8.axis_names, **kw)
            t_create = time.perf_counter() - t0
            xm = x.copy()
            for i, (what, log) in enumerate(logs(x, d.store.current.state, name, np.random.default_rng(24))[:3]):
                d.apply(log)
                xm = log.coalesce(xm.size, xm.dtype).apply_numpy(xm)
                if i == 0:
                    t0 = time.perf_counter()
                    meta = d.checkpoint()
                    t_ck = time.perf_counter() - t0
                    step = d_root / "ckpt" / f"step_{meta['seq']:08d}"
                    ck_bytes = sum(f.stat().st_size for f in step.iterdir())
            t0 = time.perf_counter()
            r = DurableEngine.restore(str(d_root), mesh=mesh8, axis_names=mesh8.axis_names)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            _require((r.current_vid, r.seq, r.replayed) == (d.current_vid, d.seq, 2),
                     f"durable {label}: restored v{r.current_vid} seq {r.seq} ({r.replayed} replayed)")
            live = d.store.current.state
            back = r.store.current.state
            pick = (lambda s: s[0]) if name == "distributed" else (lambda s: (s.blocked, s.st))
            _same_mesh_leaves(torch, pick(live), pick(back), f"durable {label} restore")
            l, rr = make_queries(np.random.default_rng(25), xm.size, 4096, "medium")
            ver = r.pin()
            idx, val = r.query(ver.state, l, rr)
            r.release(ver.vid)
            check(f"durable {label} restored", xm, l, rr, idx, val)
            print(f"[mesh-durable] {label} on (8,): create {t_create:.2f} s (base checkpoint included); "
                  f"checkpoint {t_ck:.3f} s, {ck_bytes} B on disk (the array); restore {t_restore:.2f} s, "
                  f"2 records replayed, leaves equal to the live engine's; "
                  f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
            d.close(), r.close()
            del d, r, live, back
            fresh()

    try:
        drive("durable mesh engines (8,), 2^26", durable_mesh, none=True)
    finally:
        shutil.rmtree(durable_dir, ignore_errors=True)
    print(f"[phase] online and durable mesh engines took {time.perf_counter() - t_phase:.1f} s")


def fleet_phase(torch, np, dev, drive, root) -> None:
    """Phase 7f: the replica fleet at n = 2^24 float32 on the card.

    ``run_fleet_soak`` (durable, 3 replicas, ``max_lag`` 2, 8 updates, 240
    requests of 256 queries, an injected mid-rollout crash and an external
    crash + restore, every answer held to its version's oracle) on
    ``hybrid``, then on ``sharded_hybrid`` with 8 positions of the card
    (3 replicas x 2 positions); then the serve CLI's ``--replicas 3
    --max-lag 2 --mutate 4``. The replicas launch no kernel (online
    hybrids pin the plain short path; the mesh engines run the plain
    paths)."""
    import gc

    from repro_torch.launch import serve
    from repro_torch.serve.fleet import run_fleet_soak

    t_phase = time.perf_counter()
    n = N_FLEET
    durable_dir = root / "build" / "durable"
    shutil.rmtree(durable_dir, ignore_errors=True)
    durable_dir.mkdir(parents=True)

    def soak(label, **kw):
        def run():
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            report = run_fleet_soak(replicas=3, n=n, requests=240, updates=8, qbatch=256, seed=0, max_lag=2,
                                    root=str(durable_dir / label.split()[0]), **kw)
            print(f"[fleet] {label}, n = {n}: {report.summary()}")
            print(f"[fleet]   {report.latency_summary()}; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()} B")
            _require(report.ok, f"fleet soak {label}: {report.summary()}")
            _require(report.crashes >= 2 and report.restores >= 2, f"fleet soak {label}: too few crashes")
        return run

    try:
        drive("fleet soak hybrid x3, 2^24", soak("hybrid x3", engine="hybrid", device=dev), none=True)
        drive("fleet soak sharded_hybrid x3 (2 positions each), 2^24",
              soak("sharded_hybrid x3, 2 positions each", engine="sharded_hybrid", devices=[dev] * 8), none=True)
    finally:
        shutil.rmtree(durable_dir, ignore_errors=True)

    def fleet_cli():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--engine", "hybrid", "--mode", "async", "--replicas", "3", "--max-lag", "2",
                        "--mutate", "4", "--n", str(n), "--clients", "4", "--requests", "32", "--req-batch", "256",
                        "--rate", "200", "--dist", "small"])
        text = buf.getvalue()
        print(text, end="")
        print(f"[fleet] CLI max_memory_allocated {torch.cuda.max_memory_allocated()} B")
        _require("verify: 128/128 requests bit-identical" in text and "settled=True" in text,
                 "the fleet CLI did not verify every request")

    drive("serve CLI --replicas 3 --mutate 4, 2^24", fleet_cli, none=True)
    print(f"[phase] fleet took {time.perf_counter() - t_phase:.1f} s")


# --- phase 8: the LM substrate ------------------------------------------------


def _rel_err(a, b) -> float:
    """max |a - b| over max |b| (the reference tests' measure)."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _param_tensors(params: dict):
    """The tensors of a parameter tree (a dict of tensors and dicts of them)."""
    for v in params.values():
        yield from (v.values() if isinstance(v, dict) else (v,))


def _free(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _lm_model(torch, np, dev, card, arch: str, depth32, depth16, over32: dict) -> None:
    """One model of phase 8: the float32 checks, then the bf16 serving run."""
    import dataclasses
    from unittest import mock

    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import model, moe

    cfg = configs.get_config(arch)
    b, l, k, s = LM_BATCH, LM_PROMPT, LM_CHECK_STEPS, LM_SERVE_STEPS
    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    cfg32 = dataclasses.replace(cfg, num_layers=depth32 or cfg.num_layers, cache_pad=k, **f32, **over32)
    # one slot past the timed steps: the traced step
    cfg16 = dataclasses.replace(cfg, num_layers=depth16 or cfg.num_layers, cache_pad=s + 1)
    if depth32 or depth16:
        print(f"[lm] {arch}: full width, depth cut {cfg.num_layers} -> {cfg32.num_layers} in float32 and "
              f"-> {cfg16.num_layers} in bf16 (the whole model: {cfg.param_count() * 2 / 1e9:.0f} GB in bf16)")
    for key, val in over32.items():
        print(f"[lm] {arch}: the float32 check runs at {key} = {val} (the config's: {getattr(cfg, key)}; "
              f"{cfg.num_experts} experts / top-{cfg.top_k}: no token is dropped, so decode and the full "
              f"prefill route alike)")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    tokens = pipeline.synthetic_batch(cfg32, b, l + k, seed=0, step=0, device=dev)["tokens"]

    # (1) float32: prefill + k teacher-forced decode steps against a full prefill
    p32 = model.init_params(cfg32, generator=gen(), device=dev)
    logits32, cache = model.prefill(p32, tokens[:, :l], cfg32)
    last32 = logits32[:, -1, : cfg.vocab_size]
    top32 = last32.argmax(-1)
    for t in range(k):
        step, cache = model.decode_step(p32, tokens[:, l + t : l + t + 1], cache, cfg32)
    full, _ = model.prefill(p32, tokens, cfg32)
    err = _rel_err(step, full)
    print(f"[lm] {arch} float32: prefill {b}x{l} + {k} decode steps vs a prefill of {l + k}: "
          f"relative max error {err:.3e} (bound 2e-3)")
    _require(err <= 2e-3, f"{arch}: decode vs full prefill {err} > 2e-3")
    try:
        model.decode_step(p32, tokens[:, -1:], cache, cfg32)
    except ValueError:
        print(f"[lm] {arch}: a decode step at length {cache.length} = capacity raises ValueError")
    else:
        _require(False, f"{arch}: a decode step past the cache's capacity did not raise")
    del cache, step, full, logits32

    # (2) the card against the port's CPU path, at depth 1 (one segment)
    cut = cfg.attn_every or 1
    cfg_c = dataclasses.replace(cfg32, num_layers=cut)
    p_cut = {**p32, "layers": {n: t[:1] for n, t in p32["layers"].items()}}  # views
    small = tokens[:1, : LM_CPU_TOKENS + 2]
    outs = []
    for d in (dev, torch.device("cpu")):
        p = {k: ({n: t.to(d) for n, t in v.items()} if isinstance(v, dict) else v.to(d)) for k, v in p_cut.items()}
        lg, c = model.prefill(p, small[:, :LM_CPU_TOKENS].to(d), cfg_c)
        run = [lg]
        for t in range(LM_CPU_TOKENS, LM_CPU_TOKENS + 2):
            lg, c = model.decode_step(p, small[:, t : t + 1].to(d), c, cfg_c)
            run.append(lg)
        outs.append(torch.cat(run).cpu())
        del p, c, run
    err_c = _rel_err(outs[0], outs[1])
    abs_c = float((outs[0] - outs[1]).abs().max())
    print(f"[lm] {arch} float32, {cut} layer(s), 1x{LM_CPU_TOKENS} prefill + 2 decode steps: CUDA vs CPU "
          f"max abs error {abs_c:.3e}, relative {err_c:.3e} (bound {LM_CPU_REL})")
    _require(err_c <= LM_CPU_REL, f"{arch}: CUDA vs CPU {err_c} > {LM_CPU_REL}")
    del p32, p_cut, outs
    _free(torch)

    # (3) bf16 serving: prefill, then s greedy decode steps. The bf16 prefill's
    # last logits are held to the float32 one's (the same draws, rounded to
    # bf16, at the float32 depth) within LM_BF16_REL.
    agree_cfg = None
    if cfg16.num_layers != cfg32.num_layers:  # the same draws at the float32 depth, in bf16
        agree_cfg = dataclasses.replace(cfg32, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
        pa = model.init_params(agree_cfg, generator=gen(), device=dev)
        last16 = model.prefill(pa, tokens[:, :l], agree_cfg)[0][:, -1, : cfg.vocab_size]
        del pa
        _free(torch)
    p16 = model.init_params(cfg16, generator=gen(), device=dev)
    prompt = tokens[:, :l]
    drops, routes = [], []

    def recorded(*a, **kw):
        out = moe_ffn(*a, **kw)
        drops.append(out.dropped_frac)
        return out

    def routed(*a, **kw):  # the experts a layer's kept assignments reach
        r = route(*a, **kw)
        routes.append(r.expert.reshape(r.keep.shape)[r.keep])
        return r

    moe_ffn, route = moe.moe_ffn, moe.route
    with mock.patch.object(moe, "moe_ffn", recorded):
        logits, cache = model.prefill(p16, prompt, cfg16)
    if agree_cfg is None:
        last16 = logits[:, -1, : cfg.vocab_size]
    agree = float((last16.argmax(-1) == top32).float().mean())
    err16 = _rel_err(last16.float(), last32)
    del last32
    prefill_drop = [float(d) for d in drops]
    finite = torch.isfinite(logits).all()  # on the card: no host sync per step
    tok = logits[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(s)]
    drops.clear()
    with mock.patch.object(moe, "moe_ffn", recorded), mock.patch.object(moe, "route", routed):
        for e0, e1 in events:
            e0.record()
            logits, cache = model.decode_step(p16, tok, cache, cfg16)
            e1.record()
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = float(np.median([e0.elapsed_time(e1) for e0, e1 in events]))
    decode_drop = [float(d) for d in drops]
    _require(bool(finite), f"{arch}: a bf16 logit is not finite")
    _require(err16 <= LM_BF16_REL, f"{arch}: bf16 vs float32 prefill logits {err16} > {LM_BF16_REL}")
    prefill_ms = _time_ms(torch, lambda: model.prefill(p16, prompt, cfg16), iters=5, warmup=1)
    for label, fn in (("decode step", lambda: model.decode_step(p16, tok, cache, cfg16)),
                      (f"prefill {b}x{l}", lambda: model.prefill(p16, prompt, cfg16))):
        busy, wall, ops, top = _trace_ops(torch, fn)
        print(f"[trace] {arch} bf16 {label} under torch.profiler: {ops} device ops, device busy {busy:.3f} ms "
              f"of {wall:.3f} ms (idle share {1 - busy / wall:.4f}); busiest: "
              + "; ".join(f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} x {e.key[:60]}" for e in top)
              + f" ({card})")

    # the decode step's byte bound: every bf16 weight it reads once (an untied
    # embedding table only its b rows; of the experts, those this run's steps
    # routed a kept assignment to, mean over the steps), the KV cache read at
    # each step's length, the SSM states read and written
    param_bytes = sum(t.numel() * t.element_size() for t in _param_tensors(p16))
    if not cfg.tie_embeddings:
        emb = p16["embed"]
        param_bytes -= (emb.shape[0] - b) * emb.shape[1] * emb.element_size()
    all_expert_bytes = param_bytes
    if routes:
        lay = p16["layers"]
        per_expert = sum(lay[n][0, 0].numel() * lay[n].element_size() for n in ("w_gate", "w_up", "w_down"))
        reached = float(np.mean([sum(int(torch.unique(e).numel()) for e in routes[i : i + cfg16.num_layers])
                                 for i in range(0, len(routes), cfg16.num_layers)]))
        param_bytes -= (cfg16.num_layers * cfg.num_experts - reached) * per_expert
    kv_bytes = state_bytes = 0
    if cache.k is not None:
        a_, _, _, kvh, hd = cache.k.shape
        kv_bytes = 2 * a_ * b * kvh * hd * cache.k.element_size() * float(np.mean([l + i + 1 for i in range(s)]))
    if cache.ssd is not None:
        state_bytes = 2 * (cache.conv.numel() * cache.conv.element_size() + cache.ssd.numel() * cache.ssd.element_size())
    bound_ms = (param_bytes + kv_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3
    n_active = cfg16.active_param_count()
    mfu = 2.0 * n_active * b * l / (prefill_ms / 1e3) / BF16_FLOPS
    # the projections prefill runs: no FLOPs for the embedding lookup, the
    # unembedding at each sequence's last position only, zamba2's shared
    # block at each of its applications (N_active counts it once)
    table = cfg.padded_vocab * cfg.d_model
    n_run = n_active - table * (1 if cfg.tie_embeddings else 2)
    if "shared_attn" in p16:
        n_run += (cfg16.num_layers // cfg.attn_every - 1) * sum(t.numel() for t in p16["shared_attn"].values())
    proj_flops = 2.0 * n_run * b * l + 2.0 * table * b
    mfu_proj = proj_flops / (prefill_ms / 1e3) / BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    routed_note = ""
    if routes:
        routed_note = (f"; experts routed per layer {reached / cfg16.num_layers:.2f} of {cfg.num_experts} "
                       f"(mean of {s} steps); counting all {cfg.num_experts}, as the batched einsum reads them: "
                       f"{(all_expert_bytes + kv_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    print(f"[lm] {arch} bf16 ({cfg16.num_layers} layers, {n_active} active parameters): prefill {b}x{l} "
          f"{prefill_ms:.3f} ms, {b * l / (prefill_ms / 1e3):.0f} tokens/s, MFU {mfu_proj:.4f} (the projections "
          f"prefill runs: the unembedding at the last position only, a shared block at each use) and {mfu:.4f} "
          f"(2 N_active per token) over 989 TFLOP/s; decode {decode_ms:.3f} ms per step (median of {s} greedy steps) against a byte "
          f"bound of {bound_ms:.4f} ms ({param_bytes:.0f} parameter B, {kv_bytes:.0f} KV B, {state_bytes} state B "
          f"at 3.35 TB/s{routed_note}); max_memory_allocated {peak} B; all logits finite; bf16 vs float32 prefill "
          f"logits at the last position: relative max error {err16:.3e} (bound {LM_BF16_REL}), top-1 agreement "
          f"{agree:.2f}{' (at the float32 depth)' if agree_cfg else ''} ({card})")
    if prefill_drop:
        print(f"[lm] {arch} bf16 at capacity_factor {cfg16.capacity_factor}: dropped_frac per layer, prefill "
              f"{prefill_drop}; decode mean {float(np.mean(decode_drop)):.4f}, max {max(decode_drop):.4f}")
    del p16, cache, logits, tok
    _free(torch)


def _trace_ops(torch, fn):
    """``fn()`` under ``torch.profiler`` (device activity only): device busy
    ms, window ms, device ops, the three busiest kernels. The profiler adds
    host time per op, so the window is a bound on the untraced one."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return busy_ms, wall_ms, sum(e.count for e in events), events[:3]


def lm_phase(torch, np, dev, drive, card) -> None:
    """Phase 8: the LM substrate on the card (its forward passes are torch
    ops: no kernel of ``csrc/`` runs, as no Pallas kernel runs in the
    reference's). qwen2-1.5b and zamba2-2.7b whole, grok-1-314b at full
    width with its depth cut (``LM_MODELS``); weights from a
    ``torch.Generator`` on the card, seed 0; tokens from
    ``data.pipeline.synthetic_batch`` (seed 0). Per model: (1) float32,
    prefill of 4 x 1024 with ``cache_pad`` 16, 16 teacher-forced decode
    steps, the last held to a prefill of all 1040 tokens (relative max error
    <= 2e-3, the reference's bound), and a 17th step must raise (the cache
    is full); (2) the same weights at depth 1 (zamba2: one segment) on the
    card and on the CPU, 1 x 64 tokens and two decode steps, equal within
    ``LM_CPU_REL``; (3) bf16: the same prefill, timed, its last logits held
    to the float32 prefill's within ``LM_BF16_REL``, and 32 greedy decode
    steps, every logit finite, against the decode step's byte bound. Then
    ``F.scaled_dot_product_attention`` beside the port's
    ``flash_attention`` at qwen2's prefill shape (a yardstick: the port
    never calls it), and ``data.packing.pack_documents`` on the card over
    20000 documents of at most 2048 tokens, equal to its CPU run."""
    import torch.nn.functional as F
    from unittest import mock

    from repro_torch.core import block_rmq
    from repro_torch.data import packing, pipeline
    from repro_torch.models import attention

    t_phase = time.perf_counter()
    # TF32 off for the float32 checks; the bf16 reduced-precision reduction
    # is left at PyTorch's default (on): the model's forward turns it off.
    back = torch.backends
    saved = (back.cuda.matmul.allow_tf32, back.cudnn.allow_tf32)
    back.cuda.matmul.allow_tf32 = False
    back.cudnn.allow_tf32 = False
    try:
        for arch, depth32, depth16, over32 in LM_MODELS:
            drive(f"LM {arch}", lambda: _lm_model(torch, np, dev, card, arch, depth32, depth16, over32), none=True)

        def yardstick():
            gen = torch.Generator(device=dev).manual_seed(1)
            b, l, h, kv, hd = LM_BATCH, LM_PROMPT, 12, 2, 128  # qwen2-1.5b's attention
            q = torch.randn((b, l, h, hd), generator=gen, device=dev).to(torch.bfloat16)
            kk, vv = (torch.randn((b, l, kv, hd), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
            port = attention.flash_attention(q, kk, vv, causal=True, kv_chunk=LM_PROMPT)
            lib = F.scaled_dot_product_attention(
                q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), is_causal=True, enable_gqa=True
            ).transpose(1, 2)
            err = float((port.float() - lib.float()).abs().max())
            port_ms = _time_ms(torch, lambda: attention.flash_attention(q, kk, vv, causal=True, kv_chunk=LM_PROMPT))
            lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), is_causal=True, enable_gqa=True))
            flops = 2 * 2 * b * h * l * (l + 1) / 2 * hd  # QK^T and PV over the causal half
            print(f"[lm] attention yardstick, qwen2-1.5b prefill shape q {tuple(q.shape)} bf16, causal GQA 12/2: "
                  f"port flash_attention {port_ms:.4f} ms, library_ms (F.scaled_dot_product_attention, "
                  f"is_causal, enable_gqa) {lib_ms:.4f} ms, bound {flops / BF16_FLOPS * 1e3:.4f} ms by "
                  f"operations; outputs differ by at most {err:.3e} ({card})")
            _require(err < 0.05, f"the port's flash_attention and SDPA differ by {err}")

        drive("attention yardstick", yardstick, none=True)

        def packer():
            lengths = pipeline.synthetic_documents(LM_PACK_DOCS, LM_PACK_SEQ, seed=7)
            with mock.patch.object(block_rmq, "build", wraps=block_rmq.build) as spy:
                t0 = time.perf_counter()
                assign, free = packing.pack_documents(lengths, LM_PACK_SEQ, device=dev)
                t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            a_cpu, f_cpu = packing.pack_documents(lengths, LM_PACK_SEQ, device="cpu")
            t_cpu = time.perf_counter() - t0
            _require(np.array_equal(assign, a_cpu) and np.array_equal(free, f_cpu),
                     "pack_documents on the card differs from its CPU run")
            clipped = np.minimum(lengths, LM_PACK_SEQ)
            used = np.bincount(assign, weights=clipped, minlength=free.shape[0]).astype(np.int64)
            _require((assign >= 0).all() and (used <= LM_PACK_SEQ).all() and np.array_equal(used, LM_PACK_SEQ - free),
                     "a packed bin overflows or the free space is wrong")
            bins = int((free < LM_PACK_SEQ).sum())
            eff = int(clipped.sum()) / (bins * LM_PACK_SEQ)
            _require(eff > 0.7, f"fill efficiency {eff} <= 0.7")
            print(f"[lm] pack_documents: {LM_PACK_DOCS} documents into {bins} sequences of {LM_PACK_SEQ}, fill "
                  f"efficiency {eff:.4f}, {spy.call_count} block_rmq builds; on the card {t_card:.2f} s "
                  f"({LM_PACK_DOCS / t_card:.0f} docs/s), on the CPU {t_cpu:.2f} s ({LM_PACK_DOCS / t_cpu:.0f} "
                  f"docs/s); the assignment equal integer for integer ({card})")

        drive("pack_documents 20000 docs", packer, none=True)
    finally:
        back.cuda.matmul.allow_tf32, back.cudnn.allow_tf32 = saved
    print(f"[wall] phase 8 (LM substrate) took {time.perf_counter() - t_phase:.1f} s")


# --- phase 9: LM training ----------------------------------------------------


def _held_close(name, got, want, lr_sum=0.0, ratios=None) -> float:
    """max |got - want| over max |want| of one leaf (CPU tensors); with
    ``ratios`` (an updated master leaf) only the elements whose gradient is
    zero or at least 1% of the leaf's largest count, and the others must lie
    within 2 lr: AdamW's m / sqrt(v) step carries the rounding of a small
    gradient into the update almost undiminished (tests/test_torch_train_parity.py)."""
    diff = (got.double() - want.double()).abs()
    scale = float(want.double().abs().max()) or 1.0
    if ratios is not None:
        fine = (ratios >= TRAIN_CONDITIONED) | (ratios == 0)
        _require(float(diff.max()) <= 2 * lr_sum, f"{name}: an ill-conditioned element moved past 2 lr")
        diff = diff[fine]
    return float(diff.max()) / scale if diff.numel() else 0.0


def train_phase(torch, np, dev, drive, card, root) -> dict:
    """Phase 9: LM training on the card (torch ops: no kernel of ``csrc/``
    runs, as no Pallas kernel runs in the reference's training). (a)
    qwen2-1.5b whole, bf16 params with the float32 master: 8 steps of
    ``TRAIN_BATCH x TRAIN_SEQ`` on one fixed batch, the loss must fall; step
    ms, tokens/s, MFU, the AdamW update alone against its byte bound, the
    peak. (b) the same draws at depth 1 in float32, one step on the card and
    one on the CPU: every gradient and updated master leaf within
    ``TRAIN_CPU_REL``; then in bf16 (the bounds ``TRAIN_BF16_*``, the
    master within 2 lr, the params the master cast). (c) ``run_training`` at qwen2's full width, depth 2, 8
    steps, a checkpoint every 4, a fault at step 5: one restart, the last
    checkpoint equal to the live state bit for bit. (d) the training CLI
    for granite-3-8b --smoke on the card. (e) reduced grok on a (2, 4) mesh
    of the card (2 MoE groups): 3 steps equal to the same on the CPU.
    Returns (a)'s ``step_ms`` and ``peak`` bytes."""
    import dataclasses
    from unittest import mock

    from repro_torch import checkpoint, configs
    from repro_torch._tree import leaves, tree_map
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model, moe
    from repro_torch.optim import adamw
    from repro_torch.train import runner, steps

    t_phase = time.perf_counter()
    back = torch.backends
    saved = (back.cuda.matmul.allow_tf32, back.cudnn.allow_tf32)
    back.cuda.matmul.allow_tf32 = False
    back.cudnn.allow_tf32 = False
    ckpt_root = root / "build" / "train_ckpt"
    b, l = TRAIN_BATCH, TRAIN_SEQ
    lr_fn = adamw.cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)

    def mesh_on(d, shape=(1, 1)):
        return make_mesh(shape, ("data", "model"), devices=d)

    def to(tree, d):
        return tree_map(lambda t: t.to(d), tree)

    measured = {}  # (a)'s step ms and peak bytes, for phase 10's roofline floor

    def whole():  # (a)
        cfg = configs.get_config(TRAIN_ARCH)
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        params = model.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        opt = adamw.init(params)
        n = sum(t.numel() for t in _param_tensors(params))  # param_count() leaves out the QKV biases, final norm
        step, _ = steps.make_train_step(cfg, mesh_on(dev), lr_fn=lr_fn, batch=b, seq_len=l)
        batch = pipeline.synthetic_batch(cfg, b, l, seed=0, step=0, device=dev)
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(TRAIN_STEPS)]
        losses = []
        for e0, e1 in events:
            e0.record()
            params, opt, m = step(params, opt, batch)
            e1.record()
            losses.append(m["loss"])
        torch.cuda.synchronize()
        losses = [float(x) for x in losses]
        step_ms = float(np.median([e0.elapsed_time(e1) for e0, e1 in events[2:]]))
        peak = torch.cuda.max_memory_allocated()
        _require(all(np.isfinite(losses)), f"a training loss is not finite: {losses}")
        _require(losses[-1] < losses[0], f"{TRAIN_ARCH}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
        # the AdamW update alone, on this state and one step's gradients
        _, grads = steps.value_and_grad(params, batch, cfg)
        update = lambda: adamw.update(grads, opt, lr_fn=lr_fn, param_dtype=cfg.param_dtype)
        upd_ms = _time_ms(torch, update, iters=5, warmup=1)
        # bytes it must move: each gradient (bf16) read, the master, mu and nu
        # (float32) read and written, the new bf16 params written
        upd_bytes = n * (2 + 3 * 4 * 2 + 2)
        upd_bound = upd_bytes / HBM_BYTES_PER_S * 1e3
        tokens = b * l
        mfu = 6.0 * n * tokens / (step_ms / 1e3) / BF16_FLOPS
        busy, wall, ops, top = _trace_ops(torch, lambda: step(params, opt, batch))
        print(f"[train] {TRAIN_ARCH} whole ({cfg.num_layers} layers, {n} parameters (param_count() "
              f"{cfg.param_count()}), bf16 params + float32 "
              f"master, remat={cfg.remat} policy {cfg.remat_policy!r}): {TRAIN_STEPS} steps of {b}x{l} on one batch "
              f"(seed 0), lr {TRAIN_LR} cosine (warmup {TRAIN_WARMUP}); losses "
              f"{[round(x, 4) for x in losses]}; step {step_ms:.3f} ms (median of steps 3-{TRAIN_STEPS}, CUDA "
              f"events), {tokens / (step_ms / 1e3):.0f} tokens/s, MFU {mfu:.4f} (6 N tokens per step over 989 "
              f"TFLOP/s dense bf16, the H100 SXM data sheet); the AdamW update alone {upd_ms:.3f} ms against a "
              f"byte bound of {upd_bound:.3f} ms ({upd_bytes} B at 3.35 TB/s); max_memory_allocated {peak} B "
              f"({card})")
        measured.update(step_ms=step_ms, peak=peak, losses=losses)
        print(f"[trace] {TRAIN_ARCH} train step under torch.profiler: {ops} device ops, device busy {busy:.3f} ms "
              f"of {wall:.3f} ms (idle share {1 - busy / wall:.4f}); busiest: "
              + "; ".join(f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} x {e.key[:60]}" for e in top)
              + f" ({card})")
        del params, opt, grads, step, batch
        _free(torch)

    def card_vs_cpu(dtype):  # (b)
        cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), num_layers=1, dtype=dtype, param_dtype=dtype)
        params = model.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        batch = pipeline.synthetic_batch(cfg, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, seed=0, step=0, device=dev)
        outs = []
        for d in (dev, torch.device("cpu")):
            p, bt = to(params, d), to(batch, d)
            t0 = time.perf_counter()
            loss, grads = steps.value_and_grad(p, bt, cfg)
            new, opt, m = adamw.update(grads, adamw.init(p), lr_fn=lr_fn, param_dtype=dtype)
            loss, norm = float(loss), float(m["grad_norm"])
            outs.append((loss, norm, *(to(t, "cpu") for t in (grads, opt.master, new)), time.perf_counter() - t0))
            del p, bt, grads, opt, new
        (l_gpu, n_gpu, g_gpu, w_gpu, p_gpu, t_gpu), (l_cpu, n_cpu, g_cpu, w_cpu, _, t_cpu) = outs
        lr1 = float(lr_fn(torch.tensor(1, dtype=torch.int32)))
        g_err = max(_held_close("grad", a.float(), b_.float()) for a, b_ in zip(leaves(g_gpu), leaves(g_cpu)))
        l_err = abs(l_gpu - l_cpu) / abs(l_cpu)
        n_err = abs(n_gpu - n_cpu) / n_cpu
        if dtype == torch.float32:
            w_err = max(
                _held_close("master", a, b_, lr1, (g.abs() / g.abs().max().clamp_min(1e-30)))
                for a, b_, g in zip(leaves(w_gpu), leaves(w_cpu), leaves(g_cpu))
            )
            print(f"[train] {TRAIN_ARCH} float32 depth 1, one step of {TRAIN_CPU_BATCH}x{TRAIN_CPU_SEQ}: CUDA vs CPU "
                  f"loss {l_err:.3e}, grad norm {n_err:.3e}, gradients {g_err:.3e}, updated master {w_err:.3e} "
                  f"(relative max error per leaf, bound {TRAIN_CPU_REL}; the master on the elements whose gradient "
                  f"is at least {TRAIN_CONDITIONED} of its leaf's largest, the rest within 2 lr); {t_gpu:.2f} s on "
                  f"the card, {t_cpu:.2f} s on the CPU ({card})")
            _require(max(l_err, n_err, g_err, w_err) <= TRAIN_CPU_REL, f"CUDA vs CPU train step beyond {TRAIN_CPU_REL}")
        else:
            # bf16 gradients differ by the two devices' bf16 rounding, which
            # AdamW's m / sqrt(v) step carries into any element's sign: the
            # master is held to 2 lr (a first step whose sign flipped moves
            # just under that) plus the float32 rounding of its two updates,
            # and the params must be it cast to bf16
            eps = torch.finfo(torch.float32).eps
            w_far = max(float((a.double() - b_.double()).abs().max()) for a, b_ in zip(leaves(w_gpu), leaves(w_cpu)))
            w_over = max(float((a.double() - b_.double()).abs().max() - 2 * lr1 - eps * b_.abs().max())
                         for a, b_ in zip(leaves(w_gpu), leaves(w_cpu)))
            cast = all(p_.dtype == dtype and torch.equal(p_, w.to(dtype)) for p_, w in zip(leaves(p_gpu), leaves(w_gpu)))
            print(f"[train] {TRAIN_ARCH} bf16 params (float32 master) depth 1, one step of {TRAIN_CPU_BATCH}x"
                  f"{TRAIN_CPU_SEQ}: CUDA vs CPU loss {l_err:.3e}, grad norm {n_err:.3e} (bound {TRAIN_BF16_LOSS_REL}), "
                  f"bf16 gradients {g_err:.3e} (relative max error per leaf, bound {TRAIN_BF16_GRAD_REL}), "
                  f"updated master at most {w_far:.3e} apart (bound 2 lr = {2 * lr1:.3e} plus the float32 rounding), new params the master "
                  f"cast to bf16: {cast}; {t_gpu:.2f} s on the card, {t_cpu:.2f} s on the CPU ({card})")
            _require(max(l_err, n_err) <= TRAIN_BF16_LOSS_REL and g_err <= TRAIN_BF16_GRAD_REL and w_over <= 0
                     and cast, "CUDA vs CPU bf16 train step beyond its bounds")
        del params, batch, outs
        _free(torch)

    def runner_faults():  # (c)
        cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), num_layers=TRAIN_RUNNER_DEPTH)
        shutil.rmtree(ckpt_root, ignore_errors=True)
        params = model.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        opt = adamw.init(params)
        step, _ = steps.make_train_step(cfg, mesh_on(dev), lr_fn=lr_fn, batch=b, seq_len=l)
        fired = []

        def fault(s):
            if s == TRAIN_FAULT_STEP and not fired:
                fired.append(s)
                raise RuntimeError(f"injected node failure at step {s}")

        rcfg = runner.RunnerConfig(total_steps=TRAIN_STEPS, ckpt_dir=str(ckpt_root / "run"), ckpt_every=4, seed=0)
        t0 = time.perf_counter()
        rep = runner.run_training(step, params, opt, cfg, b, l, rcfg, fault_hook=fault, device=dev)
        t_run = time.perf_counter() - t0
        latest = checkpoint.latest_step(rcfg.ckpt_dir)
        _require(rep.restarts == 1 and latest == TRAIN_STEPS,
                 f"runner: restarts {rep.restarts}, latest checkpoint {latest}")
        live = {"params": rep.params, "opt": rep.opt_state}
        t0 = time.perf_counter()
        back_tree = checkpoint.restore(rcfg.ckpt_dir, latest, live, device=dev)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        bits = lambda t: t.reshape(-1).view(torch.uint8)
        same = all(a.dtype == b_.dtype and torch.equal(bits(a), bits(b_))
                   for a, b_ in zip(leaves(live), leaves(back_tree)))
        _require(same, "the last checkpoint restored differs from the live state")
        del back_tree
        t0 = time.perf_counter()
        checkpoint.save(str(ckpt_root / "timed"), latest, live)
        t_save = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in (ckpt_root / "timed").rglob("*") if f.is_file())
        print(f"[train] run_training {TRAIN_ARCH} full width, depth {cfg.num_layers}: {rep.steps_done} steps done "
              f"for {TRAIN_STEPS} (a fault at step {TRAIN_FAULT_STEP}: {rep.restarts} restart, replayed from step 4), "
              f"latest checkpoint {latest}, restored bit for bit equal to the live state; {t_run:.2f} s in all; "
              f"a checkpoint of {sum(t.numel() * t.element_size() for t in leaves(live))} tensor bytes ({on_disk} B on disk) written in {t_save:.2f} s "
              f"(foreground), restored in {t_restore:.2f} s; losses {[round(x, 4) for x in rep.losses]} ({card})")
        del rep, live, params, opt, step
        shutil.rmtree(ckpt_root, ignore_errors=True)
        _free(torch)

    def cli():  # (d)
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-3-8b", "--smoke",
                "--steps", "8", "--ckpt-dir", str(ckpt_root / "cli")]
        shutil.rmtree(ckpt_root / "cli", ignore_errors=True)
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        t0 = time.perf_counter()
        out = subprocess.run(argv, cwd=root, env=env, capture_output=True, text=True, timeout=600)
        done = [s for s in out.stdout.splitlines() if s.startswith("done:")]
        _require(out.returncode == 0 and done and "on cuda" in done[-1],
                 f"the training CLI failed: {out.stdout[-2000:]} {out.stderr[-2000:]}")
        print(f"[train] python -m repro_torch.launch.train --arch granite-3-8b --smoke --steps 8: {done[-1]} "
              f"({time.perf_counter() - t0:.1f} s with the interpreter's start) ({card})")
        shutil.rmtree(ckpt_root, ignore_errors=True)

    def moe_mesh():  # (e)
        cfg = configs.reduce_for_smoke(configs.get_config("grok-1-314b"))
        params = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        runs = []
        groups = []
        real = moe.moe_ffn

        def recorded(*a, **kw):
            groups.append(kw.get("num_groups"))
            return real(*a, **kw)

        for d in (dev, torch.device("cpu")):
            mesh = mesh_on(d, (2, 4))
            step, _ = steps.make_train_step(cfg, mesh, lr_fn=lr_fn, batch=4, seq_len=64)
            p = to(params, d)
            o = adamw.init(p)
            losses = []
            with mock.patch.object(moe, "moe_ffn", recorded):
                for i in range(3):
                    p, o, m = step(p, o, pipeline.synthetic_batch(cfg, 4, 64, seed=0, step=i, device=d))
                    losses.append(float(m["loss"]))
            runs.append(losses)
        on_card, on_cpu = runs
        err = max(abs(a - c) / abs(c) for a, c in zip(on_card, on_cpu))
        _require(set(groups) == {2}, f"the (2, 4) mesh routed {set(groups)} MoE groups, not 2")
        print(f"[train] reduced grok-1-314b on a (2, 4) mesh of the card (8 positions, one device), MoE groups 2: "
              f"3 steps, losses {on_card} on the card and {on_cpu} on the CPU, relative max error "
              f"{err:.3e} (bound {TRAIN_MESH_REL}) ({card})")
        _require(err <= TRAIN_MESH_REL, f"the meshed grok run on the card vs the CPU: {err} > {TRAIN_MESH_REL}")

    try:
        drive(f"train {TRAIN_ARCH} whole", whole, none=True)
        drive(f"train {TRAIN_ARCH} depth 1 card vs CPU, float32", lambda: card_vs_cpu(torch.float32), none=True)
        drive(f"train {TRAIN_ARCH} depth 1 card vs CPU, bf16", lambda: card_vs_cpu(torch.bfloat16), none=True)
        drive(f"run_training {TRAIN_ARCH} depth {TRAIN_RUNNER_DEPTH} with a fault", runner_faults, none=True)
        drive("launch.train CLI granite --smoke", cli, none=True)
        drive("grok (2, 4) mesh, 2 MoE groups", moe_mesh, none=True)
    finally:
        back.cuda.matmul.allow_tf32, back.cudnn.allow_tf32 = saved
        shutil.rmtree(ckpt_root, ignore_errors=True)
    print(f"[wall] phase 9 (LM training) took {time.perf_counter() - t_phase:.1f} s")
    return measured


# --- phase 10: the dry run ----------------------------------------------------


def _dryrun_job(job):
    """One job of phase 10, in a worker process: ``("cell", arch, shape,
    mesh, compile_only)`` runs ``dryrun.run_cell``; ``("floor",)`` counts
    phase 9 (a)'s step on a one-position meta mesh. Returns the job's
    printed lines, its result and whether CUDA was initialised."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if job[0] == "cell":
            _, arch, shape, mesh, compile_only = job
            res = dryrun.run_cell(arch, shape, mesh, None, compile_only=compile_only)
        else:
            cfg = configs.get_config(TRAIN_ARCH)
            shape = configs.ShapeConfig("phase9", "train", TRAIN_SEQ, TRAIN_BATCH)
            res = dryrun._measure(cfg, shape, make_mesh((1, 1), ("data", "model"), devices="meta"))
    return buf.getvalue(), res, torch.cuda.is_initialized(), time.perf_counter() - t0


def dryrun_phase(card, step_ms: float, peak: int) -> None:
    """Phase 10: the dry run on the ``meta`` device, its jobs in worker
    processes (spawned, so none inherits this process's CUDA context; each
    must end with CUDA uninitialised). (a) ``run_cell`` on the 16 x 16 mesh
    for ``DRYRUN_ARCHS`` at every shape of ``configs.cells()``, and
    ``DRYRUN_MULTI`` compile-only on the 2 x 16 x 16 mesh: every cell must
    pass with finite, positive terms. (b) the roofline floor of phase 9
    (a)'s step: its measured ms must be at least ``max(t_compute,
    t_memory)`` of the same step counted on meta; arg + temp bytes are
    printed beside its measured peak. (c) within ``DRYRUN_SECONDS``."""
    import math
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch import configs

    t_phase = time.perf_counter()
    jobs = [("cell", a, s, "single", False) for a, s, _ in configs.cells() if a in DRYRUN_ARCHS]
    jobs.append(("cell", *DRYRUN_MULTI, "multi", True))
    jobs.append(("floor",))
    workers = max(1, min(len(jobs), os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(_dryrun_job, jobs))
    for job, (lines, rec, cuda_init, seconds) in zip(jobs, results):
        for line in lines.splitlines():
            print(f"[dryrun] {line}")
        _require(not cuda_init, f"the dry run job {job} initialised CUDA")
        if job[0] != "cell":
            continue
        _, arch, shape, mesh, compile_only = job
        _require(rec["arg_bytes_per_dev"] > 0 and rec["temp_bytes_per_dev"] > 0,
                 f"{arch} x {shape} x {mesh}: no bytes per device")
        if compile_only:
            print(f"[dryrun] {arch} x {shape} x {mesh} (compile-only): full-depth walk {rec['compile_s']} s, "
                  f"arg {rec['arg_bytes_per_dev']} B, temp {rec['temp_bytes_per_dev']:.0f} B per device, "
                  f"collectives {sorted(rec['coll_schedule_scan_artifact'])} (job {seconds:.1f} s)")
            continue
        terms = (rec["t_compute"], rec["t_memory"], rec["t_collective"])
        _require(all(math.isfinite(t) and t > 0 for t in terms), f"{arch} x {shape}: terms {terms}")
        print(f"[dryrun] {arch} x {shape} x {mesh} ({rec['chips']} H100s, computed, not measured): t_compute "
              f"{terms[0] * 1e3:.4f} ms, t_memory {terms[1] * 1e3:.4f} ms, t_collective {terms[2] * 1e3:.4f} ms, "
              f"bottleneck {rec['bottleneck']}, useful_ratio {rec['useful_ratio']:.4f} (job {seconds:.1f} s)")
    floor = results[-1][1]
    t_c = floor["flops"] / HW["peak_flops"] * 1e3
    t_m = floor["bytes"] / HW["hbm_bw"] * 1e3
    bound = max(t_c, t_m)
    held = floor["arg"] + floor["temp"]
    print(f"[dryrun] roofline floor of phase 9 (a)'s step ({TRAIN_ARCH} whole, {TRAIN_BATCH}x{TRAIN_SEQ}, bf16 "
          f"params + float32 master, remat as configured, one device): {floor['flops']:.0f} flops -> t_compute "
          f"{t_c:.3f} ms, {floor['bytes']:.0f} B unfused -> t_memory {t_m:.3f} ms; measured step {step_ms:.3f} ms "
          f"= {step_ms / bound:.4f} x the floor; arg + temp {held:.0f} B beside max_memory_allocated {peak} B "
          f"(ratio {peak / held:.4f}) ({card})")
    _require(step_ms >= bound, f"the measured step {step_ms} ms is below its roofline floor {bound} ms")
    seconds = time.perf_counter() - t_phase
    print(f"[wall] phase 10 (the dry run) took {seconds:.1f} s ({len(jobs)} jobs on {workers} processes)")
    _require(seconds < DRYRUN_SECONDS, f"the dry run took {seconds:.1f} s, over {DRYRUN_SECONDS} s")


# --- phase 12: LM training on a mesh of ranks -----------------------------------


def _ranks_job(rank: int, out: str) -> None:
    """Phase 12's work in one rank (a spawned process on ``cuda:<rank>``, in
    the NCCL group): qwen2-1.5b whole on the ``(1, n)`` mesh of ranks, its
    params placed from phase 9 (a)'s seed, ``RANKS_STEPS`` steps of phase 9
    (a)'s batch; rank 0 writes every rank's numbers to ``out/ranks.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch import _dtensor, configs
    from repro_torch._tree import leaves
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    cfg = configs.get_config(TRAIN_ARCH)
    mesh = make_mesh((1, world), ("data", "model"))
    step, info = steps.make_train_step(
        cfg, mesh, lr_fn=adamw.cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS), batch=TRAIN_BATCH, seq_len=TRAIN_SEQ
    )
    t0 = time.perf_counter()
    params = steps.place_state(mesh, info, model.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev))
    params, opt = steps.place_state(mesh, info, params, adamw.init(params))
    t_place = time.perf_counter() - t0
    n_leaves = len(leaves((params, opt)))
    sharded = sum(any(not p.is_replicate() for p in t.placements) for t in leaves((params, opt)))
    batch = pipeline.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(RANKS_STEPS)]
    losses, wall = [], []
    for e0, e1 in events:
        t0 = time.perf_counter()
        e0.record()
        params, opt, m = step(params, opt, batch)
        e1.record()
        losses.append(float(m["loss"]))
        wall.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    mine = {
        "rank": rank,
        "device": str(dev),
        "name": torch.cuda.get_device_name(dev),
        "losses": losses,
        "step_ms": [e0.elapsed_time(e1) for e0, e1 in events],
        "wall_s": wall,
        "peak": torch.cuda.max_memory_allocated(dev),
        "dtensor_leaves": sum(_dtensor.is_dtensor(t) for t in leaves((params, opt))),
        "leaves": n_leaves,
        "sharded_leaves": sharded,
        "place_s": t_place,
        "mesh": repr(mesh),
    }
    every = [None] * world
    dist.all_gather_object(every, mine)
    if rank == 0:
        (Path(out) / "ranks.json").write_text(json.dumps(every))


def ranks_phase(torch, card, root, measured: dict) -> None:
    """Phase 12 (module docstring): spawns the ranks (``launch.ranks``, a
    ``file://`` rendezvous under ``build/``), then holds their losses to
    phase 9 (a)'s. A rank that fails fails the phase."""
    from repro_torch.launch import ranks

    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    out = root / "build" / "ranks_phase"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    _free(torch)
    try:
        ranks.spawn(_ranks_job, n, str(out), device_type="cuda", init_method=f"file://{out / 'rendezvous'}")
        every = json.loads((out / "ranks.json").read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    want = measured["losses"][:RANKS_STEPS]
    first = every[0]
    _require(len(every) == n and all(r["losses"] == first["losses"] for r in every),
             f"the ranks saw different losses: {[r['losses'] for r in every]}")
    _require(first["dtensor_leaves"] == first["leaves"], f"{first['leaves'] - first['dtensor_leaves']} leaves are not DTensors")
    err = max(abs(a - w) / abs(w) for a, w in zip(first["losses"], want))
    print(f"[ranks] {TRAIN_ARCH} whole on {first['mesh']}: {n} NCCL rank(s) on {[r['device'] for r in every]} "
          f"({first['name']}); {first['leaves']} leaves, every one a DTensor, {first['sharded_leaves']} sharded (an "
          f"axis of one rank shards nothing); "
          f"placed in {first['place_s']:.2f} s; {RANKS_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} on phase 9 (a)'s "
          f"batch and schedule ({card})")
    print(f"[ranks] losses {first['losses']} against phase 9 (a)'s {want}: relative max error {err:.3e} "
          f"(bound {RANKS_LOSS_REL}, the bf16 loss bound of tests/test_torch_train_parity.py)")
    print(f"[ranks] step ms {[round(x, 3) for x in first['step_ms']]} (CUDA events; the first step includes "
          f"DTensor's sharding propagation, host wall {[round(x, 3) for x in first['wall_s']]} s) against phase 9 "
          f"(a)'s {measured['step_ms']:.3f} ms on one device ({card})")
    print(f"[ranks] max_memory_allocated per rank {[r['peak'] for r in every]} B against phase 9 (a)'s "
          f"{measured['peak']} B on one device ({card})")
    _require(err <= RANKS_LOSS_REL, f"the ranks' losses {first['losses']} vs phase 9's {want}: {err} > {RANKS_LOSS_REL}")
    print(f"[wall] phase 12 (training on a mesh of ranks) took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    """Runs every phase with the calibration cache in a temporary file of
    this run, so that no cache on the machine feeds it."""
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_calib_")
    os.environ["RMQ_TORCH_CALIB_CACHE"] = str(Path(cache_dir) / "calibration.json")
    try:
        return _main()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def _main() -> int:
    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 1

    from repro_torch import checkpoint as ckpt_mod
    from repro_torch import update
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.core import build as build_mod
    from repro_torch.core import calib_cache, hybrid, lane_rmq, ref, registry, sparse_table
    from repro_torch.kernels import _build, ops, tuning
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
    from repro_torch.fault import DurableEngine
    from repro_torch.launch import serve
    from repro_torch.obs import Tracer, set_tracer
    from repro_torch.serve import RMQServer, ServeConfig
    from repro_torch.serve.workload import make_queries, run_poisson_clients

    # --- phase 1: card, versions, kernel build ------------------------------
    card = _card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    print(f"[card] {card}")
    print(
        f"[versions] torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"nvcc {nvcc.stdout.strip().splitlines()[-1]}; device {torch.cuda.get_device_name(0)}"
    )
    _disk_free(root)
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)")
    for line in (_build.build_log or "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            print(f"[build]   {line.strip()}")

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    kernels = {}
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    # --- phase 2: block_min -------------------------------------------------
    nb = 1 << 19
    for bs in (128, 256):
        for kind in ("f32", "i32"):
            if kind == "f32":
                xb = torch.from_numpy(rng.random(nb * bs, dtype=np.float32)).to(dev).reshape(nb, bs)
            else:
                xb = torch.from_numpy(rng.integers(0, 3, nb * bs).astype(np.int32)).to(dev).reshape(nb, bs)
            kv, ki = block_min(xb)
            pv, pi = block_min_plain(xb)
            torch.cuda.synchronize()
            _require(torch.equal(kv, pv) and torch.equal(ki, pi), f"block_min {kind} bs={bs} != plain")
            t = kernel_times(torch, lambda: block_min(xb), "block_min_kernel", flush)
            plain_ms = _time_ms(torch, lambda: block_min_plain(xb))
            lib_ms = _time_ms(torch, lambda: torch.min(xb, dim=1))
            bound_ms = (nb * bs * 4 + nb * 8) / HBM_BYTES_PER_S * 1e3
            err = _max_abs_err(torch, kv, pv)
            print(
                f"[block_min] {kind} nb={nb} bs={bs}: equal to plain (max_abs_err {err}); "
                f"kernel {t['ms']} ms on the device ({t['cold_ms']} ms with L2 flushed), "
                f"{t['call_ms']:.4f} ms per wrapper call; plain {plain_ms:.4f} ms, "
                f"torch.min {lib_ms:.4f} ms, bound {bound_ms:.4f} ms"
            )
            if kind == "f32" and bs == 128:  # the served shape: n = 2^26 float32
                kernels["block_min"] = dict(
                    **t, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=lib_ms, max_abs_err=err,
                )
            del xb, kv, ki, pv, pi

    # --- phase 3: fused_query -----------------------------------------------
    for n, own in ((N_RESIDENT, "resident"), (N_MAIN, "dma")):
        for kind in ("f32", "i32"):
            if kind == "f32":
                x = rng.random(n, dtype=np.float32)
            else:
                x = rng.integers(0, 3, n).astype(np.int32)
            s = ops.build(x, 128, device=dev)
            nbk = s.x_blocks.shape[0]
            for b in (4096, 4099):
                l, r = _queries(rng, n, b)
                lt = torch.from_numpy(l).to(dev)
                rt = torch.from_numpy(r).to(dev)
                args = (s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, lt, rt)
                tables = dict(st_val=s.st_val, st_gidx=s.st_gidx)
                out = {}
                for fetch in ("resident", "dma"):
                    ki, kv = fused_query(*args, **tables, fetch=fetch)
                    pi, pv = fused_query_plain(*args, **tables, fetch=fetch)
                    torch.cuda.synchronize()
                    _require(
                        torch.equal(ki, pi) and torch.equal(kv, pv),
                        f"fused_query {fetch} {kind} n={n} B={b} != plain",
                    )
                    out[fetch] = (ki, kv)
                    if b != 4096 or (kind != "f32" and fetch != own):
                        continue
                    # Both fetches are timed at both sizes, so the two read
                    # strategies (and RESIDENT_NB_CEILING) are compared at one
                    # n; the row keeps the fetch the size selects.
                    call = lambda: fused_query(*args, **tables, fetch=fetch)
                    t = kernel_times(torch, call, "fused_query_kernel", flush)
                    plain_ms = _time_ms(
                        torch, lambda: fused_query_plain(*args, **tables, fetch=fetch)
                    )
                    bound_ms = _fq_bytes(l, r, 128, 4, fetch) / HBM_BYTES_PER_S * 1e3
                    err = _max_abs_err(torch, kv, pv)
                    print(
                        f"[fused_query] {fetch} {kind} n={n} nb={nbk} B={b}: equal to plain "
                        f"(max_abs_err {err}); kernel {t['ms']} ms/batch on the device, "
                        f"{t['cold_ms']} ms with L2 flushed, {t['call_ms']:.4f} ms per wrapper "
                        f"call; plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms"
                    )
                    if kind == "f32" and fetch == own:
                        kernels[f"fused_query[{fetch}]"] = dict(
                            **t, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=None,
                            max_abs_err=err,
                        )
                _require(
                    torch.equal(out["resident"][0], out["dma"][0])
                    and torch.equal(out["resident"][1], out["dma"][1]),
                    f"fused_query resident != dma ({kind} n={n} B={b})",
                )
                print(f"[fused_query] {kind} n={n} B={b}: resident == dma == plain")
            del s, args, tables  # the served runs measure their own peak memory

    # --- phase 4: fused_query_packed, rmq_partials, lane_partials ------------
    def same_bits(a, b) -> bool:
        return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))

    euler = euler_depths(EULER_HEIGHT)
    packed_cases = [
        ("packed32", "i32", N_RESIDENT, "resident"),
        ("packed32", "euler", euler.size, "dma"),
        ("quantized", "f32", N_RESIDENT, None),
        ("quantized", "i32", N_RESIDENT, None),
        ("quantized", "f32", N_MAIN, "resident"),
        ("quantized", "i32", N_MAIN, None),
        ("packed64", "f32", N_MAIN, "resident"),
        ("packed64", "i32", N_MAIN, None),
    ]
    # The quantized body is fused_query_kernel over the QuantizedCells interior.
    kname = {
        "packed32": "fused_query_packed32_kernel",
        "packed64": "fused_query_packed64_kernel",
        "quantized": "QuantizedCells",
    }
    # The word layouts read both fetches' names (one body each).
    fetches = {"packed32": ("resident", "dma"), "packed64": ("resident", "dma"), "quantized": ("resident",)}
    torch.cuda.reset_peak_memory_stats()
    for layout, kind, n, timed in packed_cases:
        if kind == "f32":
            x = rng.random(n, dtype=np.float32)
        elif kind == "i32":
            x = rng.integers(-24, 25, n).astype(np.int32)  # key span 49: packed32 fits
        else:
            x = euler
        s, spec = ops.build_packed(x, 128, layout=layout, device=dev)
        nbk = s.blocks.shape[0]
        print(f"[fused_query_packed] {layout} {kind} n={n} nb={nbk}: spec {spec}")
        for b in (4096, 4099):
            l, r = _queries(rng, n, b)
            lt = torch.from_numpy(l).to(dev)
            rt = torch.from_numpy(r).to(dev)
            args = (s.blocks, s.stw, lt, rt)
            kw = dict(spec=spec, bmin_val=s.bmin_val)
            pi, pv = fused_query_packed_plain(*args, **kw)
            outs = {}
            for fetch in fetches[layout]:
                ki, kv = fused_query_packed(*args, **kw, fetch=fetch)
                torch.cuda.synchronize()
                _require(
                    torch.equal(ki, pi) and same_bits(kv, pv),
                    f"fused_query_packed {layout} {fetch} {kind} n={n} B={b} != plain",
                )
                outs[fetch] = (ki, kv)
                if b != 4096 or fetch != timed:
                    continue
                # The two fetches of a word layout launch one body (checked
                # equal below): the row times the fetch the size selects.
                call = lambda: fused_query_packed(*args, **kw, fetch=fetch)
                t = kernel_times(torch, call, kname[layout], flush)
                if layout == "packed32":  # the floor: one query alone
                    t1 = kernel_times(
                        torch, lambda: fused_query_packed(s.blocks, s.stw, lt[:1], rt[:1], **kw, fetch=fetch),
                        kname[layout], flush,
                    )
                    print(
                        f"[fused_query_packed] {layout} {fetch} {kind} n={n} B=1: kernel "
                        f"{t1['ms']} ms on the device, {t1['cold_ms']} ms with L2 flushed"
                    )
                name = f"fused_query_packed[{layout},{fetch}]" if layout == "packed32" else f"fused_query_packed[{layout}]"
                plain_ms = _time_ms(torch, lambda: fused_query_packed_plain(*args, **kw))
                bound_ms = _packed_bytes(l, r, 128, 4, layout) / HBM_BYTES_PER_S * 1e3
                err = _max_abs_err(torch, kv, pv)
                print(
                    f"[fused_query_packed] {layout} {fetch} {kind} n={n} B={b}: equal to plain "
                    f"(max_abs_err {err}); kernel {t['ms']} ms/batch on the device, "
                    f"{t['cold_ms']} ms with L2 flushed, {t['call_ms']:.4f} ms per wrapper "
                    f"call; plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms"
                )
                kernels[name] = dict(
                    **t, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=None, max_abs_err=err,
                )
            if layout != "quantized":
                _require(
                    torch.equal(outs["resident"][0], outs["dma"][0])
                    and same_bits(outs["resident"][1], outs["dma"][1]),
                    f"fused_query_packed resident != dma ({kind} n={n} B={b})",
                )
            sample = slice(0, 256)
            gold = ref.rmq_ref(x, l[sample], r[sample])
            _require(bool((pi[sample].cpu().numpy() == gold).all()), f"packed {layout} {kind} != oracle")
            print(f"[fused_query_packed] {layout} {kind} n={n} B={b}: kernel == plain (all fetches), oracle OK on 256")
        del s, args, kw
    print(
        f"[fused_query_packed] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
        "(packed builds up to n = 2^26)"
    )

    for kind in ("f32", "i32"):
        x = rng.random(N_MAIN, dtype=np.float32) if kind == "f32" else rng.integers(0, 3, N_MAIN).astype(np.int32)
        fs = ops.build(x, 128, device=dev)
        ls_ = lane_rmq.build(x, device=dev)
        planes = (ls_.xs, ls_.suff_val, ls_.suff_idx, ls_.pref_val, ls_.pref_idx)
        for b in (4096, 4099):
            l, r = _queries(rng, N_MAIN, b)
            lt = torch.from_numpy(l).to(dev)
            rt = torch.from_numpy(r).to(dev)
            bl, br = lt // 128, rt // 128
            ls, re = lt - bl * 128, rt - br * 128
            pargs = (fs.x_blocks, bl, br, ls, torch.where(bl == br, re, 127), re)
            kv, ki = rmq_partials(*pargs)
            pv, pi = rmq_partials_plain(*pargs)
            sl, sr = lt // 128, rt // 128
            largs = (*planes, sl, sr, lt - sl * 128, rt - sr * 128)
            lkv, lki = lane_partials(*largs)
            lpv, lpi = lane_partials_plain(*largs)
            two = ops.query(fs, lt, rt, fused=False)
            one = ops.query(fs, lt, rt)
            lq = ops.lane_query(ls_, lt, rt)
            lr = lane_rmq.query(ls_, lt, rt)
            torch.cuda.synchronize()
            _require(torch.equal(ki, pi) and same_bits(kv, pv), f"rmq_partials {kind} B={b} != plain")
            _require(torch.equal(lki, lpi) and same_bits(lkv, lpv), f"lane_partials {kind} B={b} != plain")
            _require(torch.equal(two[0], one[0]) and same_bits(two[1], one[1]), f"two-pass != fused ({kind} B={b})")
            _require(torch.equal(lq[0], lr[0]) and torch.equal(lq[1], lr[1]), f"lane_query != lane_rmq ({kind} B={b})")
            gold = ref.rmq_ref(x, l[:256], r[:256])
            _require(
                bool((two[0][:256].cpu().numpy() == gold).all() and (lq[0][:256].cpu().numpy() == gold).all()),
                f"two-pass / lane query != oracle ({kind} B={b})",
            )
            print(f"[partials] {kind} n={N_MAIN} B={b}: rmq_partials, lane_partials == plain; two-pass == fused; lane_query == lane_rmq; oracle OK on 256")
            if kind != "f32" or b != 4096:
                continue
            for name, call, plain, pname, nbytes, err in (
                ("rmq_partials", lambda: rmq_partials(*pargs), lambda: rmq_partials_plain(*pargs),
                 "rmq_partials_kernel", _partials_bytes(l, r, 128, 4), _max_abs_err(torch, kv, pv)),
                ("lane_partials", lambda: lane_partials(*largs), lambda: lane_partials_plain(*largs),
                 "lane_partials_kernel", _lane_bytes(l, r, 4), _max_abs_err(torch, lkv, lpv)),
            ):
                t = kernel_times(torch, call, pname, flush)
                plain_ms = _time_ms(torch, plain)
                bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                print(
                    f"[{name}] f32 n={N_MAIN} B={b}: equal to plain (max_abs_err {err}); kernel "
                    f"{t['ms']} ms/batch on the device, {t['cold_ms']} ms with L2 flushed, "
                    f"{t['call_ms']:.4f} ms per wrapper call; plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.6f} ms"
                )
                kernels[name] = dict(
                    **t, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=None, max_abs_err=err,
                )
            # lane_partials where about half the queries lie inside one lane
            # block (lengths uniform in [1, 128]), and one query alone.
            sl_, sr_ = _queries(np.random.default_rng(5), N_MAIN, b, max_len=128)
            slt, srt = torch.from_numpy(sl_).to(dev), torch.from_numpy(sr_).to(dev)
            short = (*planes, slt // 128, srt // 128, slt % 128, srt % 128)
            got, want = lane_partials(*short), lane_partials_plain(*short)
            torch.cuda.synchronize()
            _require(all(same_bits(g, w) for g, w in zip(got, want)), "lane_partials != plain on short ranges")
            first = tuple(a[:1] for a in largs[5:])
            for what, a in (("lengths in [1, 128]", short), ("B=1", (*planes, *first))):
                t = kernel_times(torch, lambda: lane_partials(*a), "lane_partials_kernel", flush)
                print(
                    f"[lane_partials] f32 n={N_MAIN} {what}: kernel {t['ms']} ms on the device, "
                    f"{t['cold_ms']} ms with L2 flushed"
                )
            del short, first, a  # the served runs measure their own peak memory
        del fs, ls_, planes, pargs, largs

    # The long path: sparse_query at the benchmark cell's size, n = 10^8 and
    # a batch of 2^22 lengths uniform in [1, n] (the table's k * n passes
    # 2^31 from k = 22) with doubling_edges' queries; float32 timed, int32
    # checked. The plain chain is timed by CUDA events (``plain_ms``) and
    # by the device time of all its kernels.
    gen = torch.Generator(device=dev).manual_seed(9)
    q = 1 << 22
    length = torch.randint(1, N_LONG + 1, (q,), generator=gen, device=dev)
    lo = (torch.rand(q, generator=gen, device=dev, dtype=torch.float64) * (N_LONG - length + 1)).long()
    lo = torch.minimum(lo, N_LONG - length)
    el, er = (torch.from_numpy(a).to(dev) for a in doubling_edges(N_LONG))
    lt = torch.cat([lo.int(), el])
    rt = torch.cat([(lo + length - 1).int(), er])
    for kind in ("f32", "i32"):
        if kind == "f32":
            x = torch.rand(N_LONG, generator=gen, device=dev)
        else:
            x = torch.randint(-1000, 1000, (N_LONG,), generator=gen, device=dev, dtype=torch.int32)
        st = sparse_table.build(x)
        ki, kv = sparse_query(st.idx, x, lt, rt)
        pi, pv = sparse_query_plain(st.idx, x, lt, rt)
        torch.cuda.synchronize()
        _require(torch.equal(ki, pi) and same_bits(kv, pv), f"sparse_query {kind} n={N_LONG} != plain")
        print(f"[sparse_query] {kind} n={N_LONG} B={lt.numel()} levels={st.idx.shape[0]}: kernel == plain, bit for bit")
        if kind == "f32":
            t = kernel_times(torch, lambda: sparse_query(st.idx, x, lt, rt), "sparse_query_kernel", flush)
            plain_ms = _time_ms(torch, lambda: sparse_query_plain(st.idx, x, lt, rt))
            plain_device_ms = all_kernels_ms(torch, lambda: sparse_query_plain(st.idx, x, lt, rt))
            bound_ms = lt.numel() * SPARSE_BYTES_PER_QUERY / HBM_BYTES_PER_S * 1e3
            err = _max_abs_err(torch, kv, pv)
            print(
                f"[sparse_query] f32 n={N_LONG} B={lt.numel()}: equal to plain (max_abs_err {err}); "
                f"kernel {t['ms']} ms/batch on the device, {t['cold_ms']} ms with L2 flushed, "
                f"{t['call_ms']:.4f} ms per wrapper call; plain {plain_ms:.4f} ms "
                f"({plain_device_ms:.4f} ms of device time), bound {bound_ms:.6f} ms"
            )
            kernels["sparse_query"] = dict(
                **t, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=None, max_abs_err=err,
            )
        del st, x, ki, kv, pi, pv
    del lt, rt, lo, length, el, er

    # --- phase 4b: every kernel on edge_batch, bs = 128 and 256 -------------
    def on_maxval_only(idx, xq, lq, rq, label):
        """``idx`` (a kernel's answer) equals the numpy oracle on every query
        whose range holds only maxval; returns how many there were."""
        lq, rq = (a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in (lq, rq))
        carve = maxval_only(xq, lq, rq)
        got = idx.cpu().numpy()[carve]
        _require(bool((got == ref.rmq_ref(xq, lq[carve], rq[carve])).all()),
                 f"{label}: a maxval-only range != oracle")
        return int(carve.sum())

    for bs in (128, 256):
        for dtype in ("float32", "int32"):
            for b in (1, 4099):
                x, l, r = edge_batch(bs, dtype, b)
                lt = torch.from_numpy(l).to(dev)
                rt = torch.from_numpy(r).to(dev)
                what = f"edge_batch bs={bs} {dtype} B={b}"
                n_max = 0  # maxval-only queries held to the oracle
                fs = ops.build(x, bs, device=dev)
                _require(
                    all(same_bits(k, p) for k, p in zip(block_min(fs.x_blocks), block_min_plain(fs.x_blocks))),
                    f"block_min != plain on {what}",
                )
                args = (fs.x_blocks, fs.bmin_val, fs.bmin_gidx, fs.st.idx, lt, rt)
                tables = dict(st_val=fs.st_val, st_gidx=fs.st_gidx)
                for fetch in ("resident", "dma"):
                    want = fused_query_plain(*args, **tables, fetch=fetch)
                    for tile in (1, 8):
                        got = fused_query(*args, **tables, fetch=fetch, tile=tile)
                        _require(
                            all(same_bits(g, w) for g, w in zip(got, want)),
                            f"fused_query {fetch} tile={tile} != plain on {what}",
                        )
                        n_max += on_maxval_only(got[0], x, l, r, f"fused_query {fetch} tile={tile} on {what}")
                bl, br = lt // bs, rt // bs
                ls, re = lt - bl * bs, rt - br * bs
                pargs = (fs.x_blocks, bl, br, ls, torch.where(bl == br, re, bs - 1), re)
                got = rmq_partials(*pargs)
                _require(
                    all(same_bits(g, w) for g, w in zip(got, rmq_partials_plain(*pargs))),
                    f"rmq_partials != plain on {what}",
                )
                n_max += on_maxval_only(got[1], x, l, r, f"rmq_partials on {what}")
                # packed32 needs a small key span: the batch's small-span values
                xp, lp, rp = edge_batch(bs, dtype, b, small_span=True)
                packed = {
                    "quantized": (edge_batch(bs, dtype, b, finite=True)[0], l, r),
                    "packed32": (xp, lp, rp),
                    "packed64": (x, l, r),
                }
                for layout, (xq, lq, rq) in packed.items():
                    lq, rq = torch.from_numpy(lq).to(dev), torch.from_numpy(rq).to(dev)
                    q, spec = ops.build_packed(xq, bs, layout=layout, device=dev)
                    kw = dict(spec=spec, bmin_val=q.bmin_val)
                    want = fused_query_packed_plain(q.blocks, q.stw, lq, rq, **kw)
                    for fetch in fetches[layout]:
                        for tile in (1, 8):
                            got = fused_query_packed(q.blocks, q.stw, lq, rq, **kw, fetch=fetch, tile=tile)
                            _require(
                                all(same_bits(g, w) for g, w in zip(got, want)),
                                f"fused_query_packed {layout} {fetch} tile={tile} != plain on {what}",
                            )
                            if layout != "packed32":  # packed32's small-span values hold no maxval
                                n_max += on_maxval_only(got[0], xq, lq, rq, f"quantized tile={tile} on {what}")
                ls_ = lane_rmq.build(x, device=dev)
                planes = (ls_.xs, ls_.suff_val, ls_.suff_idx, ls_.pref_val, ls_.pref_idx)
                # ... and a batch whose queries all lie inside single lane blocks
                brng = np.random.default_rng(bs + b)
                blk = brng.integers(0, x.size // 128, b)
                blk[: b // 4] = brng.integers(2 * bs // 128, 6 * bs // 128, b // 4)  # rows of the maxval blocks
                lo, hi = brng.integers(0, 128, b), brng.integers(0, 128, b)
                inside = (blk * 128 + np.minimum(lo, hi), blk * 128 + np.maximum(lo, hi))
                for lq, rq in ((lt, rt), tuple(torch.from_numpy(a.astype(np.int32)).to(dev) for a in inside)):
                    sl, sr = lq // 128, rq // 128
                    largs = (*planes, sl, sr, lq - sl * 128, rq - sr * 128)
                    want = lane_partials_plain(*largs)
                    for tile in (1, 8):
                        got = lane_partials(*largs, tile=tile)
                        _require(
                            all(same_bits(g, w) for g, w in zip(got, want)),
                            f"lane_partials tile={tile} != plain on {what}",
                        )
                        n_max += on_maxval_only(got[1], x, lq, rq, f"lane_partials tile={tile} on {what}")
                _require(n_max > 0, f"no maxval-only range on {what}")
                print(
                    f"[edge_batch] bs={bs} {dtype} B={b}: every kernel == plain, bit for bit (tiles 1 and 8); "
                    f"{n_max} maxval-only answers (kernel, tile, query) equal to the oracle"
                )
    del flush  # the served runs measure their own peak memory
    print(f"[phase] kernels checked at {time.perf_counter() - t_start:.1f} s")

    # --- phase 5: the served paths ------------------------------------------
    counters = {
        "block_min": lambda: block_min.launches,
        "fused_query[resident]": lambda: fused_query.launches_by_fetch["resident"],
        "fused_query[dma]": lambda: fused_query.launches_by_fetch["dma"],
        "fused_query_packed[packed32,resident]": lambda: fused_query_packed.launches_by_body["packed32[resident]"],
        "fused_query_packed[packed32,dma]": lambda: fused_query_packed.launches_by_body["packed32[dma]"],
        "fused_query_packed[quantized]": lambda: fused_query_packed.launches_by_body["quantized"],
        "fused_query_packed[packed64]": lambda: fused_query_packed.launches_by_body["packed64"],
        "rmq_partials": lambda: rmq_partials.launches,
        "lane_partials": lambda: lane_partials.launches,
        "sparse_query": lambda: sparse_query.launches,
    }
    counts = dict.fromkeys(counters, 0)

    def reset_counts():
        block_min.launches = 0
        fused_query.launches = 0
        fused_query.launches_by_fetch = {"resident": 0, "dma": 0}
        fused_query_packed.launches = 0
        fused_query_packed.launches_by_body = dict.fromkeys(fused_query_packed.launches_by_body, 0)
        rmq_partials.launches = 0
        lane_partials.launches = 0
        sparse_query.launches = 0

    def drive(label, fn, must=(), none=False, some=()):
        """Run one served path with the counts at 0; ``must`` kernels have to
        launch in it, at least one of ``some``, and with ``none`` no kernel
        may."""
        reset_counts()
        fn()
        run = {k: get() for k, get in counters.items()}
        for k in must:
            _require(run[k] > 0, f"{k} was not launched by {label}")
        if some:
            _require(any(run[k] > 0 for k in some), f"none of {some} was launched by {label}")
        if none:
            _require(not any(run.values()), f"{label} launched a kernel: {run}")
        for k, v in run.items():
            counts[k] += v
        print(f"[served] {label}: launches {json.dumps({k: v for k, v in run.items() if v})}")

    def cli(argv):
        return lambda: serve.main(argv)  # prints verify lines; exits 1 on a mismatch

    oneshot = ["--mode", "oneshot", "--batch", "4096", "--batches", "8", "--dist", "small"]
    asy = ["--mode", "async", "--clients", "4", "--requests", "32", "--req-batch", "256"]
    unpacked = ("block_min",)
    drive("hybrid oneshot 2^26", cli([*oneshot, "--engine", "hybrid", "--n", str(N_MAIN)]),
          (*unpacked, "fused_query[dma]"))
    drive("fused128 oneshot 2^26", cli([*oneshot, "--engine", "fused128", "--n", str(N_MAIN)]),
          (*unpacked, "fused_query[dma]"))
    # "auto" picks the fetch by the block count: resident up to the ceiling.
    n_auto_resident = tuning.RESIDENT_NB_CEILING * 128
    fq_fetch = lambda n, bs=128: f"fused_query[{tuning.resolve_fetch('auto', -(-n // bs))}]"
    p32_fetch = lambda n: f"fused_query_packed[packed32,{tuning.resolve_fetch('auto', -(-n // 128))}]"
    drive("hybrid oneshot 2^20", cli([*oneshot, "--engine", "hybrid", "--n", str(N_RESIDENT)]),
          (*unpacked, fq_fetch(N_RESIDENT)))
    drive(f"hybrid oneshot {n_auto_resident}", cli([*oneshot, "--engine", "hybrid", "--n", str(n_auto_resident)]),
          (*unpacked, "fused_query[resident]"))
    torch.cuda.reset_peak_memory_stats()
    for dist in ("small", "medium"):
        # medium lengths (about n^0.6) pass the sqrt(n) threshold: the long path's kernel.
        drive(f"hybrid async {dist} 2^26",
              cli([*asy, "--engine", "hybrid", "--n", str(N_MAIN), "--dist", dist]),
              (*unpacked, *(("sparse_query",) if dist == "medium" else ())))
    print(f"[served] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes (async hybrid, n={N_MAIN})")

    torch.cuda.reset_peak_memory_stats()
    quant = ["--engine", "packed_hybrid", "--packed", "quantized", "--n", str(N_MAIN)]
    drive("packed_hybrid quantized oneshot 2^26", cli([*oneshot, *quant]), ("fused_query_packed[quantized]",))
    drive("packed_hybrid quantized async small 2^26", cli([*asy, *quant, "--dist", "small"]),
          ("fused_query_packed[quantized]",))
    print(f"[served] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes (packed_hybrid quantized, n={N_MAIN})")

    def auto_layout():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main([*oneshot, "--engine", "packed_hybrid", "--n", str(N_MAIN)])
        text = buf.getvalue()
        print(text, end="")
        _require("layout packed64" in text, "packed_hybrid on float32 data did not resolve to packed64")
        print("[served] packed_hybrid --packed auto on float32 n=2^26 resolved to layout packed64")

    torch.cuda.reset_peak_memory_stats()
    drive("packed_hybrid auto oneshot 2^26", auto_layout, ("fused_query_packed[packed64]",))
    print(f"[served] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes (packed_hybrid packed64, n={N_MAIN})")

    def packed32_batches(x, label):
        def run():
            t0 = time.perf_counter()
            state = registry.build_for_serving("packed_hybrid", x, device=dev, packed="packed32")
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            qrng = np.random.default_rng(1)
            served, t_serve = 0, 0.0
            for _ in range(8):
                l, r = make_queries(qrng, x.size, 4096, "small")
                t0 = time.perf_counter()
                idx, val = hybrid.query(state, l, r)
                torch.cuda.synchronize()
                t_serve += time.perf_counter() - t0
                gold = ref.rmq_ref(x, l, r)
                _require(
                    bool((idx.cpu().numpy() == gold).all() and (val.cpu().numpy() == x[gold]).all()),
                    f"packed32 {label} != oracle",
                )
                served += l.size
            print(
                f"[packed_hybrid] packed32 {label} n={x.size}: build {t_build * 1e3:.1f} ms, "
                f"served {served} RMQs in {t_serve * 1e3:.1f} ms ({t_serve / served * 1e9:.1f} ns/RMQ), "
                f"verify: {served}/{served} equal to the oracle"
            )
        return run

    torch.cuda.reset_peak_memory_stats()
    drive("packed_hybrid packed32 Euler oneshot", packed32_batches(euler, "Euler tour"),
          ("fused_query_packed[packed32,dma]",))
    print(f"[served] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes (packed_hybrid packed32, n={euler.size})")
    small_span = np.random.default_rng(2).integers(-24, 25, N_RESIDENT).astype(np.int32)
    drive("packed_hybrid packed32 oneshot 2^20", packed32_batches(small_span, "span 49"),
          (p32_fetch(N_RESIDENT),))
    drive(f"packed_hybrid packed32 oneshot {n_auto_resident}",
          packed32_batches(small_span[:n_auto_resident], "span 49"),
          ("fused_query_packed[packed32,resident]",))

    def entry_point_batches():
        x = np.random.default_rng(3).random(N_MAIN, dtype=np.float32)
        fs = ops.build(x, 128, device=dev)
        ls_ = lane_rmq.build(x, device=dev)
        qrng = np.random.default_rng(4)
        for _ in range(8):
            l, r = make_queries(qrng, N_MAIN, 4096, "small")
            two = ops.query(fs, l, r, fused=False)
            lq = ops.lane_query(ls_, l, r)
            gold = ref.rmq_ref(x, l, r)
            for name, (idx, val) in (("ops.query(fused=False)", two), ("ops.lane_query", lq)):
                _require(
                    bool((idx.cpu().numpy() == gold).all() and (val.cpu().numpy() == x[gold]).all()),
                    f"{name} != oracle",
                )
        print(f"[served] ops.query(fused=False) and ops.lane_query: 8 x 4096 small ranges at n={N_MAIN}, all equal to the oracle")

    drive("two-pass and lane entry points 2^26", entry_point_batches, ("rmq_partials", "lane_partials"))

    def maxval_batches():
        """Ranges whose every element is the dtype's maximum, served on the
        card: the three-element inputs of the engines test, then arrays of
        n = 2^20 with maxval runs crossing blocks (float32 +inf and int32
        INT32_MAX). Every answer is the oracle's, the first index of such a
        range (ROADMAP.md §3: the reference answers outside the range)."""
        small = {
            "float32": np.array([0.0, np.inf, np.inf], np.float32),
            "int32": np.array([5, 2**31 - 1, 2**31 - 1], np.int32),
        }
        l3, r3 = np.array([1, 2, 1]), np.array([2, 2, 1])
        names = ("block128", "block256", "lane", "fused128", "fused128_dma", "hybrid", "exhaustive")
        for dtype, x in small.items():
            for name in names:
                spec = registry.get(name)
                idx, val = spec.query(spec.build(x, device=dev), l3, r3)
                check(f"{name} {dtype} maxval-only n=3", x, l3, r3, idx, val)
        qrng = np.random.default_rng(8)
        for dtype in ("float32", "int32"):
            if dtype == "float32":
                x = qrng.random(N_RESIDENT, dtype=np.float32)
                big = np.float32(np.inf)
            else:
                x = qrng.integers(-1000, 1000, N_RESIDENT).astype(np.int32)
                big = np.int32(2**31 - 1)
            starts = qrng.integers(0, N_RESIDENT - 3000, 64)
            lens = qrng.integers(50, 3000, 64)
            for a, ln in zip(starts, lens):
                x[a : a + ln] = big
            # half the queries inside a run (crossing 128-blocks), half anywhere
            pick = qrng.integers(0, 64, 2048)
            lo = starts[pick] + qrng.integers(0, lens[pick])
            hi = starts[pick] + qrng.integers(0, lens[pick])
            lr, rr = make_queries(qrng, N_RESIDENT, 2048, "small")
            l = np.concatenate([np.minimum(lo, hi), lr]).astype(np.int32)
            r = np.concatenate([np.maximum(lo, hi), rr]).astype(np.int32)
            _require(bool(maxval_only(x, l, r)[:2048].all()), "the run queries hold only maxval")
            for name in ("block128", "lane", "fused128_dma", "hybrid", "exhaustive"):
                spec = registry.get(name)
                idx, val = spec.query(spec.build(x, device=dev), l, r)
                check(f"{name} {dtype} maxval runs n=2^20", x, l, r, idx, val)
            fs = ops.build(x, 128, device=dev)
            check(f"ops.query(fused=False) {dtype} maxval runs", x, l, r, *ops.query(fs, l, r, fused=False))
            check(f"ops.lane_query {dtype} maxval runs", x, l, r, *ops.lane_query(lane_rmq.build(x, device=dev), l, r))
            if dtype == "int32":  # a finite value range: quantized takes it
                q = registry.build_for_serving("packed_hybrid", x, device=dev, packed="quantized", threshold=N_RESIDENT)
                check(f"packed_hybrid quantized {dtype} maxval runs", x, l, r, *hybrid.query(q, l, r))
        print(f"[maxval] {checked[1]} maxval-only answers (of {checked[0]} checked) equal to the oracle: "
              f"the first index of each range")

    checked = [0, 0]  # answers checked against the oracle; of them on maxval-only ranges

    def check(label, x, l, r, idx, val):
        gold = ref.rmq_ref(x, l, r)
        _require(
            bool((idx.cpu().numpy() == gold).all() and (val.cpu().numpy() == x[gold]).all()),
            f"{label} != oracle",
        )
        checked[0] += len(gold)
        checked[1] += int(maxval_only(x, np.asarray(l), np.asarray(r)).sum())

    drive("maxval-only ranges (n = 3, 2^20)", maxval_batches,
          ("block_min", "fused_query[resident]", "fused_query[dma]", "fused_query_packed[quantized]",
           "rmq_partials", "lane_partials"))
    for name, c in counts.items():
        _require(c > 0, f"{name} was not launched on the served paths")
    _device_busy_share(torch, np, dev)

    # --- phase 7: crossover, autotuner, cached serve, baselines -------------
    print(f"[calib] cache file {calib_cache.default_path()} (this run's own; empty until now)")
    for n in (N_MAIN, N_RESIDENT):
        for layout in (None, "quantized", "packed32"):
            if layout is None:
                must = ("block_min", fq_fetch(n))
            elif layout == "quantized":
                must = ("fused_query_packed[quantized]",)
            else:
                must = (p32_fetch(n),)
            box = {}

            def run(n=n, layout=layout, box=box):
                t0 = time.perf_counter()
                box["thr"] = hybrid.calibrate(n, layout=layout, device=dev)
                box["s"] = time.perf_counter() - t0

            name = layout or "unpacked"
            drive(f"calibrate {name} n={n}", run, must)
            print(
                f"[calib] {name} n={n}: crossover {box['thr']} (sqrt(n) = "
                f"{round(n ** 0.5)}; lengths swept {np.unique(np.geomspace(1, n, 8).astype(np.int64)).tolist()}) "
                f"in {box['s']:.2f} s"
            )

    for n in (N_MAIN, N_RESIDENT):
        winners = []
        for rep in (1, 2):
            box = {}

            def run(n=n, box=box):
                t0 = time.perf_counter()
                box["res"] = tuning.sweep(n, 4096, device=dev)
                box["s"] = time.perf_counter() - t0

            cands = tuning.candidate_configs(n)
            drive(f"tuning.sweep n={n} run {rep}", run,
                  some=tuple({f"fused_query[{c.fetch}]" for c in cands}), must=("block_min",))
            res = box["res"]
            _require(len(res) == len(cands), f"sweep n={n} timed {len(res)} of {len(cands)} candidates")
            for cfg, sec in res:
                print(f"[tune] n={n} run {rep}: tile={cfg.tile} fetch={cfg.fetch} bs={cfg.block_size}: {sec * 1e6:.1f} us per call")
            best = min(res, key=lambda cv: cv[1])[0]
            winners.append(best)
            print(f"[tune] n={n} run {rep}: winner tile={best.tile} fetch={best.fetch} bs={best.block_size} ({box['s']:.2f} s)")
        print(f"[tune] n={n}: the two runs {'agree' if winners[0] == winners[1] else 'DISAGREE'} on the winner")

    measured = [0]
    real_measure = hybrid._measure

    def counted(*a, **k):
        measured[0] += 1
        return real_measure(*a, **k)

    hybrid._measure = counted
    try:
        cal = ["--engine", "hybrid", "--calibrate", "--tune", "--n", str(N_MAIN)]
        for dist in ("small", "medium"):
            measured[0] = 0
            drive(f"hybrid --calibrate --tune async {dist} 2^26", cli([*asy, *cal, "--dist", dist]), ("block_min",),
                  some=("fused_query[resident]", "fused_query[dma]") if dist == "small" else ())
            print(f"[calib] hybrid --calibrate --tune async {dist}: {measured[0]} measurements")
            if dist == "small":
                _require(measured[0] > 0, "the first calibrated and tuned serve measured nothing")
            else:
                _require(measured[0] == 0, f"the second calibrated and tuned serve measured {measured[0]} times")
    finally:
        hybrid._measure = real_measure
    print(f"[calib] cache entries {json.dumps(json.loads(Path(calib_cache.default_path()).read_text())['entries'])}")

    for mode in (oneshot, asy):
        argv = [*mode, "--engine", "lca", "--n", str(N_RESIDENT)]
        if mode is oneshot:  # every query of the last batch checked (async: every request)
            argv += ["--verify", "4096"]
        drive(f"lca {mode[1]} 2^20", cli(argv), none=True)

    def exhaustive_batches():
        spec = registry.get("exhaustive")
        qrng = np.random.default_rng(6)
        x = qrng.random(N_RESIDENT, dtype=np.float32)
        l, r = make_queries(qrng, N_RESIDENT, 4096, "medium")
        zeros = np.zeros(N_RESIDENT, np.float32)
        for name, xs in (("random", x), ("all-equal", zeros)):
            t0 = time.perf_counter()
            idx, val = spec.query(spec.build(xs, device=dev), l, r)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            gold = ref.rmq_ref(xs, l, r)
            _require(
                idx.dtype == torch.int32 and bool((idx.cpu().numpy() == gold).all())
                and bool((val.cpu().numpy() == xs[gold]).all()),
                f"exhaustive {name} != oracle",
            )
            if name == "all-equal":
                _require(bool((idx.cpu().numpy() == l).all()), "exhaustive all-equal: not the leftmost")
            print(f"[exhaustive] {name} n={N_RESIDENT}: 4096 medium ranges in {t * 1e3:.1f} ms, all equal to the oracle")

    drive("exhaustive registry 2^20", exhaustive_batches, none=True)

    # --- phase 7b: online updates -------------------------------------------
    def online_serve():
        """``--mutate 8`` at n = 2^26 with clients that keep sending while
        the eight batches apply one after another (4 clients x 400 requests
        at 4 per second: about 100 s), and a threshold pinned in this run's
        cache that splits the `small` lengths (about n^0.3), so the patched
        full-array table serves part of every launch. A request answered at
        a version between the first and the last was served while the next
        batch applied (all eight are queued within the first second)."""
        calib_cache.store(calib_cache.cache_key(N_MAIN, 128), ONLINE_THRESHOLD)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--mode", "async", "--clients", "4", "--requests", "400", "--rate", "4",
                        "--req-batch", "256", "--engine", "hybrid", "--mutate", "8",
                        "--n", str(N_MAIN), "--dist", "small"])
        text = buf.getvalue()
        print(text, end="")
        _require(f"threshold {ONLINE_THRESHOLD}," in text, "the online hybrid did not take the pinned threshold")
        _require("mutate: 8 update batches applied" in text, "not every update batch was applied")
        split = text.split("regime split ", 1)[1].split(" long", 1)[0]  # "<short> short / <long>"
        _require(min(int(w) for w in split.split(" short / ")) > 0,
                 f"the online serve did not send ranges down both paths: {split}")
        line = next(s for s in text.splitlines() if "served versions (vid: requests):" in s)
        vids = ast.literal_eval(line.split(":", 2)[2].strip())
        last = 8  # the base version is 0; each batch publishes one
        between = sum(c for v, c in vids.items() if 0 < v < last)
        print(f"[online] requests served at v0: {vids.get(0, 0)}, while a later batch applied "
              f"(v1..v{last - 1}): {between}, at the last version v{last}: {vids.get(last, 0)}")
        _require(between > 0, f"no request was served while an update applied: {vids}")

    torch.cuda.reset_peak_memory_stats()
    drive("hybrid async --mutate 8 2^26", online_serve, none=True)
    print(f"[online] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes (hybrid --mutate 8, n={N_MAIN})")

    def online_library():
        """Each updatable engine at n = 2^20 through a point write, a fill and
        an append: the oracle after every update, a version pinned before
        them answering from its own tensors, and the final state equal to a
        from-scratch build on the card leaf for leaf, dtypes included."""
        qrng = np.random.default_rng(9)
        f32 = qrng.random(N_RESIDENT, dtype=np.float32)
        span = qrng.integers(-24, 25, N_RESIDENT).astype(np.int32)
        cases = [
            ("sparse_table", {}, f32, None),
            ("block128", {}, f32, None),
            ("block256", {}, f32, None),
            # a threshold that splits the `small` lengths (about n^0.3 = 64)
            ("hybrid", {"threshold": 64}, f32, None),
            # packed32 on small-span int32; the append past 2^20 overflows the
            # 20-bit index field and rebuilds under a fresh spec
            ("packed_hybrid", {"packed": "packed32"}, span, "packed32"),
            ("packed_hybrid", {"packed": "quantized"}, f32, "quantized"),
            ("packed_hybrid", {}, f32, "packed64"),  # float32 auto -> packed64
        ]
        for name, kw, x, layout in cases:
            t0 = time.perf_counter()
            online = update.make_online(name, x, device=dev, **kw)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            if layout is not None:
                _require(online.store.current.state.spec.layout == layout, f"{name} {kw} resolved to another layout")
            ver0 = online.pin()
            before = [t.cpu().clone() for _, t in _leaves(ver0.state)]
            l0, r0 = make_queries(qrng, x.size, 4096, "small")
            xm = x.copy()
            lo = np.int32(-24) if x.dtype == np.int32 else np.float32(-1.0)
            logs = [
                update.DeltaLog().point(int(qrng.integers(0, x.size)), lo),
                update.DeltaLog().fill(1000, 1063, lo + 1),
                update.DeltaLog().append(x[:32].copy()),
            ]
            line = []
            for log in logs:
                res = online.apply(log)
                xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
                l, r = make_queries(qrng, xm.size, 4096, "small")
                ver = online.pin()
                idx, val = online.query(ver.state, l, r)
                online.release(ver.vid)
                check(f"online {name} {layout or ''} v{res.version}", xm, l, r, idx, val)
                line.append(f"v{res.version} {'patched' if res.patched else 'rebuilt'} "
                            f"{res.seconds * 1e3:.1f} ms {res.publish_bytes} B")
            idx, val = online.query(ver0.state, l0, r0)
            check(f"online {name} {layout or ''} pinned v0", x, l0, r0, idx, val)
            _require(all(torch.equal(a, b.cpu()) for a, (_, b) in zip(before, _leaves(ver0.state))),
                     f"online {name}: a published tensor was written")
            online.release(ver0.vid)
            thr = getattr(online.store.current.state, "threshold", None)
            if thr is not None:
                plan = build_mod.plan_for("hybrid", xm.size, device=dev, threshold=int(thr),
                                          use_kernels=False, packed=online.plan.meta.get("packed"))
                fresh = build_mod.execute(plan, xm)
            else:
                fresh = registry.get(name).build(xm, device=dev)
            want, got = _leaves(fresh), _leaves(online.store.current.state)
            _require([p for p, _ in want] == [p for p, _ in got], f"online {name}: other leaves")
            for (path, a), (_, b) in zip(want, got):
                _require(a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b)),
                         f"online {name} {layout or ''}: leaf {path} != a from-scratch build")
            print(f"[online] {name} {layout or ''} n={x.size}: build {t_build * 1e3:.1f} ms; "
                  f"{'; '.join(line)}; oracle after every update, pinned v0 intact, "
                  f"{len(got)} leaves equal to a from-scratch build")

    drive("online engines 2^20 (library)", online_library, none=True)

    # --- phase 7c: durability -----------------------------------------------
    durable_dir = root / "build" / "durable"
    shutil.rmtree(durable_dir, ignore_errors=True)
    durable_dir.mkdir(parents=True)

    def tensor_leaves(state):
        return [(k, t) for k, t in _flatten(state) if isinstance(t, torch.Tensor)]

    def pcts(xs):
        return " ".join(f"{q} {np.percentile(xs, p) * 1e3:.2f} ms" for q, p in (("p50", 50), ("p99", 99))) if xs else "none"

    def check_all(label, x, answered):
        """``check`` over many requests' ``(l, r, idx, val)`` at once (one
        pass of its maxval count over x, not one per request)."""
        l, r, idx, val = (np.concatenate(a) for a in zip(*answered))
        check(label, x, l, r, torch.from_numpy(idx), torch.from_numpy(val))

    def on_disk(step_dir: Path) -> int:
        return sum(f.stat().st_size for f in step_dir.iterdir())

    def durable_library():
        """(a): n = 2^26 through ``DurableEngine``: create, two write batches,
        a checkpoint under reader traffic, a write batch and an append, a
        crash, a restore; leaves, oracle and ``RMQServer(restore=)``."""
        lib = durable_dir / "lib"
        need = 2 * _hybrid_snapshot_bytes(N_MAIN)
        free = _disk_free(durable_dir)
        _require(free > need + (1 << 30),
                 f"{free} bytes free under {durable_dir}, the two checkpoints of n = {N_MAIN} need about "
                 f"{need}: run this phase at the largest n that fits")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        x = np.random.default_rng(0).random(N_MAIN, dtype=np.float32)
        tracer = Tracer(enabled=True)
        prev = set_tracer(tracer)
        try:
            spans = lambda name: [s for s in tracer.spans() if s.name == name]
            t0 = time.perf_counter()
            d = DurableEngine.create("hybrid", x, str(lib), device=dev, threshold=ONLINE_THRESHOLD)
            torch.cuda.synchronize()
            t_create = time.perf_counter() - t0
            base_ck = spans("checkpoint")[0].duration_s
            print(f"[durable] hybrid n={N_MAIN}: build {t_create - base_ck:.2f} s; base checkpoint "
                  f"{base_ck:.2f} s, {on_disk(lib / 'ckpt' / 'step_00000000')} B on disk")
            mrng = np.random.default_rng(77)  # phase 7b's mutator

            def batch(i, cur_n):
                log = update.DeltaLog()
                for _ in range(3):
                    log.point(int(mrng.integers(0, cur_n)), float(mrng.random()))
                if i % 3 == 1:
                    a = int(mrng.integers(0, cur_n - 1))
                    log.fill(a, min(a + 63, cur_n - 1), float(mrng.random()))
                if i % 4 == 3:
                    log.append(mrng.random(32, dtype=np.float32))
                return log

            xm = x.copy()

            def apply(i):
                nonlocal xm
                log = batch(i, d.n)
                res = d.apply(log)
                xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
                append_ms = spans("journal_append")[-1].duration_s * 1e3
                print(f"[durable] seq {d.seq}: journal append {append_ms:.3f} ms (fsync), apply "
                      f"{res.seconds:.2f} s, {res.n_writes} writes + {res.n_appended} appended, "
                      f"publish_bytes {res.publish_bytes}")

            apply(0)
            apply(1)
            # The mid checkpoint while clients send `small` requests through a
            # server over the durable engine (no update meanwhile: v2 answers).
            srv = RMQServer(online=d, config=ServeConfig(n=N_MAIN),
                            warmup_bounds=build_mod.warmup_bounds(d.plan)).start()
            srv.warmup()
            window = {}

            def clients():
                window["out"] = run_poisson_clients(
                    4, 80, 4.0, lambda rng, c: make_queries(rng, N_MAIN, 256, "small"),
                    lambda l, r: (time.perf_counter(), srv.submit(l, r)), seed=20_000)

            th = threading.Thread(target=clients, name="ckpt-clients")
            th.start()
            time.sleep(1.0)
            t_ck0 = time.perf_counter()
            meta = d.checkpoint()
            t_ck1 = time.perf_counter()
            th.join()
            during, outside, answered = [], [], []
            for out in window["out"]:
                for (l, r), sub in out:
                    _require(sub is not None, "a request was refused during the checkpoint")
                    t_sub, fut = sub
                    res = fut.result(timeout=300)
                    _require(res.version == 2, f"a request answered at version {res.version}")
                    answered.append((l, r, res.idx, res.val))
                    (during if t_ck0 <= t_sub <= t_ck1 else outside).append(res.timing.total_s)
            srv.close()
            check_all("durable v2 during the checkpoint", xm, answered)
            _require(meta["seq"] == 2 and len(during) > 0, f"no request arrived during the checkpoint: {meta}")
            print(f"[durable] mid checkpoint {t_ck1 - t_ck0:.2f} s, {on_disk(lib / 'ckpt' / 'step_00000002')} B "
                  f"on disk; requests submitted during it: {len(during)}, {pcts(during)}; "
                  f"the other {len(outside)}: {pcts(outside)} (4 clients at 4/s, 256 small ranges each)")
            apply(2)
            apply(3)
            live = [(k, t.cpu()) for k, t in tensor_leaves(d.store.current.state)]
            vid, seq = d.current_vid, d.seq
            d.close()  # the crash: only the root survives
            del d, srv
            gc.collect()
            torch.cuda.empty_cache()

            t0 = time.perf_counter()
            arrays, _, step = ckpt_mod.load_snapshot(str(lib / "ckpt"))
            t_load = time.perf_counter() - t0
            del arrays
            t0 = time.perf_counter()
            r = DurableEngine.restore(str(lib), device=dev)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            t_replay = spans("restore")[-1].duration_s
            print(f"[durable] restore {t_restore:.2f} s: load {t_load:.2f} s (step {step}, timed alone "
                  f"just before), upload and mirrors {t_restore - t_load - t_replay:.2f} s, replay "
                  f"{t_replay:.2f} s ({r.replayed} records); version {r.current_vid}, seq {r.seq}")
            _require(r.replayed == 2 and (r.current_vid, r.seq) == (vid, seq),
                     f"restore: replayed {r.replayed}, version {r.current_vid}, seq {r.seq}; live {vid}, {seq}")
            got = tensor_leaves(r.store.current.state)
            _require([k for k, _ in got] == [k for k, _ in live], "restored leaves differ from the live ones")
            for (k, a), (_, b) in zip(live, got):
                _require(a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a.to(dev), b)),
                         f"restored leaf {k} != the live engine's")
            del live
            fresh = update.make_online("hybrid", xm, device=dev, threshold=ONLINE_THRESHOLD)
            want = tensor_leaves(fresh.store.current.state)
            _require([k for k, _ in want] == [k for k, _ in got], "a from-scratch build has other leaves")
            for (k, a), (_, b) in zip(want, got):
                _require(a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b)),
                         f"restored leaf {k} != a from-scratch build")
            print(f"[durable] {len(got)} restored leaves bit-identical to the live engine's and to a "
                  f"from-scratch make_online of the oracle array (n={xm.size})")
            r.close()
            del r, fresh, want, got
            gc.collect()
            torch.cuda.empty_cache()

            t0 = time.perf_counter()
            srv = RMQServer(restore=str(lib), device=dev, config=ServeConfig(n=xm.size))
            t_srv = time.perf_counter() - t0
            with srv:
                per_client = run_poisson_clients(
                    4, 32, 200.0, lambda rng, c: make_queries(rng, xm.size, 256, "small"), srv.submit,
                    seed=10_000)
                answered = []
                for out in per_client:
                    for (l, rq), fut in out:
                        _require(fut is not None, "RMQServer(restore=) refused a request")
                        res = fut.result(timeout=300)
                        answered.append((l, rq, res.idx, res.val))
            check_all("RMQServer(restore=)", xm, answered)
            st = srv.stats()
            srv.online.close()
            print(f"[durable] RMQServer(restore=) restored in {t_srv:.2f} s (version "
                  f"{srv.online.current_vid}); {st.served_requests} requests x 256 small ranges equal to the "
                  f"oracle; p50 {st.p50_total_s * 1e3:.2f} ms p99 {st.p99_total_s * 1e3:.2f} ms")
            print(f"[durable] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes (phase 7c (a))")
        finally:
            set_tracer(prev)

    def durable_cli():
        """(b): the serve CLI's restart path at n = 2^20, twice on one root."""
        d_root = str(durable_dir / "cli")
        argv = ["--engine", "hybrid", "--mode", "async", "--mutate", "4", "--restore", d_root,
                "--n", str(N_RESIDENT)]
        texts = []
        for run in (1, 2):
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    serve.main(argv)
            finally:
                texts.append(buf.getvalue())
                print(texts[-1], end="")
            _require("verify: 128/128 requests bit-identical" in texts[-1], f"CLI run {run} did not verify")
        _require("restored from" not in texts[0], "the first run found a root")
        line = f"restored from {d_root}: version 4, seq 4, n="
        _require(line in texts[1] and "(4 journal records replayed)" in texts[1],
                 "the second CLI run did not restore the first's root")
        _require(all(f"update v{v}:" in texts[1] for v in range(5, 9)),
                 "the second run's batches did not continue at versions 5-8")

    def chaos_soaks():
        """(c): the seeded chaos soak through the CLI, each updatable engine."""
        for name in update.online_names():
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    serve.main(["--chaos", "7", "--n", str(N_RESIDENT), "--engine", name,
                                "--restore", str(durable_dir / f"chaos_{name}")])
            finally:
                text = buf.getvalue()
                summary = [s for s in text.splitlines() if s.startswith(("[OK]", "[FAIL]"))]
                print("\n".join(summary) if summary else text, end="\n")
            failures, recoveries, failed_ckpts = _chaos_faults(summary[0])
            _require(summary[0].startswith("[OK]"), f"chaos {name}: {summary[0]}")
            _require(failures >= 1 and recoveries >= 1 and failed_ckpts >= 1,
                     f"chaos {name}: no recovered apply failure or no failed checkpoint")

    try:
        drive("durable hybrid 2^26 (library)", durable_library, none=True)
        drive("durable CLI --restore twice 2^20", durable_cli, none=True)
        drive("chaos soaks 2^20", chaos_soaks, none=True)
    finally:
        shutil.rmtree(durable_dir, ignore_errors=True)

    # --- phase 7d: the mesh engines -----------------------------------------
    mesh_phase(torch, np, dev, drive, check)

    # --- phase 7e: online and durable mesh engines --------------------------
    mesh_online_phase(torch, np, dev, drive, check, root)

    # --- phase 7f: the replica fleet ----------------------------------------
    fleet_phase(torch, np, dev, drive, root)

    # --- phase 8: the LM substrate ------------------------------------------
    lm_phase(torch, np, dev, drive, card)

    # --- phase 9: LM training ------------------------------------------------
    measured = train_phase(torch, np, dev, drive, card, root)

    # --- phase 10: the dry run ------------------------------------------------
    drive("the dry run", lambda: dryrun_phase(card, measured["step_ms"], measured["peak"]), none=True)

    # --- phase 12: LM training on a mesh of ranks (before phase 11's lines) ---
    drive(f"train {TRAIN_ARCH} whole on a mesh of ranks", lambda: ranks_phase(torch, card, root, measured), none=True)

    # --- phase 11: the kernels line and the result --------------------------
    fq = "src/repro/kernels/fused_query.py"
    source = {
        "block_min": ("src/repro_torch/csrc/block_min.cu", "src/repro/kernels/block_min.py:47"),
        "fused_query[resident]": ("src/repro_torch/csrc/fused_query.cu", f"{fq}:310"),
        "fused_query[dma]": ("src/repro_torch/csrc/fused_query.cu", f"{fq}:310"),
        "fused_query_packed[packed32,resident]": ("src/repro_torch/csrc/fused_query_packed.cu", f"{fq}:599"),
        "fused_query_packed[packed32,dma]": ("src/repro_torch/csrc/fused_query_packed.cu", f"{fq}:599"),
        "fused_query_packed[quantized]": ("src/repro_torch/csrc/fused_query_packed.cu", f"{fq}:561"),
        # No Pallas body: the reference serves packed64 with its jnp query.
        "fused_query_packed[packed64]": ("src/repro_torch/csrc/fused_query_packed.cu", "src/repro/core/block_rmq.py:291"),
        "rmq_partials": ("src/repro_torch/csrc/rmq_partials.cu", "src/repro/kernels/rmq_query.py:107"),
        "lane_partials": ("src/repro_torch/csrc/lane_partials.cu", "src/repro/kernels/lane_query.py:104"),
        # No Pallas body: the reference's doubling-table query is jnp ops.
        "sparse_query": ("src/repro_torch/csrc/sparse_query.cu", "src/repro/core/sparse_table.py:79"),
    }
    rows = []
    for name, m in kernels.items():
        src, replaces = source[name]
        rows.append(
            {
                "name": name,
                "route": "cuda",
                "source": src,
                "replaces": replaces,
                "launches": counts[name],
                "max_abs_err": m["max_abs_err"],
                "ms": m["ms"],
                "cold_ms": m["cold_ms"],
                "call_ms": m["call_ms"],
                "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"],
                "bound_by": "bytes",
                "library_ms": m["library_ms"],
            }
        )
    _require(len(rows) == 10, f"a kernel has no measurement ({sorted(kernels)})")
    print(json.dumps({"kernels": rows}))
    print(f"[wall] chip_smoke.py took {time.perf_counter() - t_start:.1f} s (imports and kernel build included)")
    print(card)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
