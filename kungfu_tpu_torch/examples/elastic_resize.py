"""Elastic training on a step schedule, resized at runtime, with a resume
across sizes from a checkpoint (counterpart of examples/elastic_resize.py).

    python -m kungfu_tpu_torch.examples.elastic_resize --backend gloo
    python -m kungfu_tpu_torch.examples.elastic_resize --device cpu \\
        --schedule 2:2,3:2

Without ``--kf-rank`` this process is the launcher: it starts a config
server, PUTs a cluster of the schedule's first size and runs the watcher
(``launcher.watch.watch_run``), which starts one process per worker, a
process for each worker the cluster gains, and reaps each it loses.
Every worker trains a least-squares model through
:class:`~kungfu_tpu_torch.elastic.DistributedElasticTrainer`; rank 0
proposes each stage of ``--schedule`` (``np:steps,...``) through
:class:`~kungfu_tpu_torch.elastic.ScheduledResizePolicy`, and the ranks
apply it at the next step's fence.  At half the schedule the job
checkpoints and ends; a fresh job at the size of the next stage resumes
from the checkpoint and trains the rest.

Every step trains one global batch of ``--batch`` rows from an
:class:`~kungfu_tpu_torch.elastic.ElasticDataShard` (the batch is drawn
before the step's fence, so its size cannot follow the cluster's, as the
JAX example's per-lane batch does); each rank takes its block.  Rank 0
prints a line per step, and with ``--json`` writes them as a list.
``--device`` defaults to ``cuda``; several ranks on one card need
``--backend gloo`` (NCCL refuses two ranks on one card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..checkpoint import Checkpointer
from .. import detached
from ..elastic import (BasePolicy, ConfigServer, DistributedElasticTrainer,
                       ElasticDataShard, PolicyRunner, ScheduledResizePolicy,
                       Stage, StepSchedule)
from ..launcher import env as E
from ..launcher.watch import watch_run
from ..optimizers import synchronous_sgd
from ..plan import Cluster, HostList
from ..utils.device import resolve_device
from .ranks import ROOT

SAMPLES, D_IN, D_OUT = 4096, 16, 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedule", default="2:5,4:5,8:5,4:5",
                    help="np:steps,... (the cluster size at each step)")
    ap.add_argument("--batch", type=int, default=48,
                    help="global batch (rows); every size of the schedule "
                         "must divide it")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--json", default=None,
                    help="rank 0's per-step records, as a JSON list")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the launcher waits for each job")
    ap.add_argument("--job", choices=("first", "second"), default="first",
                    help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--restore", action="store_true", help=argparse.SUPPRESS)
    E.add_args(ap)
    return ap.parse_args(argv)


def until(schedule: StepSchedule, steps: int) -> StepSchedule:
    """The schedule's first ``steps`` steps."""
    stages, left = [], steps
    for s in schedule.stages:
        if left <= 0:
            break
        stages.append(Stage(s.size, min(s.steps, left)))
        left -= s.steps
    return StepSchedule(stages)


def worker(args, we) -> None:
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", we.rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    schedule = StepSchedule.parse(args.schedule)
    half = schedule.total_steps() // 2
    rng = np.random.RandomState(0)
    xs = torch.from_numpy(rng.randn(SAMPLES, D_IN).astype(np.float32))
    ys = torch.from_numpy(rng.randn(SAMPLES, D_OUT).astype(np.float32))
    shard = ElasticDataShard(SAMPLES)

    def loss_fn(p, batch):
        x, y = batch
        return ((x @ p["w"] - y) ** 2).mean()

    trainer = DistributedElasticTrainer(
        loss_fn,
        lambda leaves, n: synchronous_sgd(torch.optim.SGD(leaves,
                                                          lr=args.lr)),
        {"w": torch.zeros(D_IN, D_OUT, device=device)}, env=we,
        backend=args.backend)
    ckpt = Checkpointer(args.ckpt)
    if args.restore:
        at = trainer.restore_checkpoint(ckpt)
        if trainer.rank == 0:
            print(f"resumed step {at} at ranks={trainer.n}", flush=True)
    records = []

    def batch_fn(tr):
        idx = torch.from_numpy(shard.batch_indices(tr.trained_samples,
                                                   args.batch))
        return xs[idx].to(device), ys[idx].to(device)

    class Log(BasePolicy):
        def after_step(self, ctx):
            records.append({"job": args.job, "step": ctx.step - 1,
                            "ranks": trainer.n,
                            "samples": trainer.trained_samples,
                            "version": trainer.version})

    sched = until(schedule, half) if args.job == "first" else schedule
    losses = PolicyRunner([ScheduledResizePolicy(sched), Log()], trainer,
                          SAMPLES, 1).run(batch_fn, schedule.total_steps())
    for rec, loss in zip(records, losses):
        rec["loss"] = loss
        if trainer.rank == 0:
            print(f"step {rec['step']:3d} ranks={rec['ranks']} "
                  f"loss={loss:.4f} samples={rec['samples']}")
    if trainer.rank == 0 and args.json:
        old = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                old = json.load(f)
        with open(args.json, "w") as f:
            json.dump(old + records, f)
    if detached():
        return
    if args.job == "first":
        trainer.save_checkpoint(ckpt)
        ckpt.wait()
        if trainer.rank == 0:
            print(f"checkpointed at step {trainer.step_count} "
                  f"({trainer.trained_samples} samples)")
    elif trainer.rank == 0:
        print(f"done: {trainer.trained_samples} samples, final "
              f"ranks={trainer.n}")
    trainer.shutdown()


def launch(args, argv) -> int:
    """Run the two jobs (see the module docstring)."""
    resolve_device(args.device)             # no card: fail here, not later
    schedule = StepSchedule.parse(args.schedule)
    half = schedule.total_steps() // 2
    sizes = [s.size for s in schedule.stages]
    for n in sizes:
        if args.batch % n:
            raise SystemExit(f"--batch {args.batch} does not split over "
                             f"{n} ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    server = ConfigServer().start()
    try:
        with tempfile.TemporaryDirectory(prefix="kft_elastic_") as tmp:
            hosts = HostList.parse(f"127.0.0.1:{max(sizes)}")
            for job, size in (("first", schedule.size_at(0)),
                              ("second", schedule.size_at(half))):
                start = server.put_cluster(Cluster.from_hostlist(hosts,
                                                                 size))

                def argv_for(rank, cluster, version, job=job, start=start):
                    extra = ["--restore"] if (job == "second"
                                              and version == start) else []
                    return [sys.executable, "-m", __spec__.name, *argv,
                            "--job", job, "--ckpt",
                            os.path.join(tmp, "ckpt"), *extra,
                            *E.worker_argv(rank, cluster.workers, version,
                                           server.url,
                                           os.path.join(tmp, "rdzv"))]

                logs = os.path.join(tmp, job)
                os.makedirs(logs)
                exits = watch_run(server, argv_for, logs, env=env,
                                  cwd=str(ROOT), timeout=args.timeout)
                rank0 = os.path.join(logs, sorted(exits)[0] + ".log")
                with open(rank0) as f:
                    sys.stdout.write(f.read())
                print(f"job {job}: {len(exits)} worker processes, exit "
                      f"codes {sorted(exits.values())}", flush=True)
    finally:
        server.stop()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    we = E.install(E.from_args(args))
    if we.singleton:
        return launch(args, argv)
    worker(args, we)
    return 0


if __name__ == "__main__":
    sys.exit(main())
