"""Elastic ZeRO-3 training resized at runtime, its sharded state re-sharded
at every change (counterpart of examples/sharded_elastic.py).

    python -m kungfu_tpu_torch.examples.sharded_elastic
    python -m kungfu_tpu_torch.examples.sharded_elastic --device cpu \\
        --schedule 2:4,3:4,1:4

Without ``--kf-rank`` this process is the launcher: it starts a config
server, PUTs a cluster of the schedule's first size and runs the watcher
(``launcher.watch.watch_run``), which starts one process per worker and
one for each worker the cluster gains.  Every worker trains a
least-squares model under
:class:`~kungfu_tpu_torch.elastic.ShardedElasticTrainer` (Adam; the
parameters and both moments sharded 1/n a rank), and rank 0 proposes each
stage of ``--schedule`` (``np:steps,...``); the ranks apply it at the next
step's fence, where the state is re-sharded rather than re-broadcast.
Each worker prints its state bytes and every change of size; rank 0
prints every step's loss, which does not depend on the sizes.
``--device`` defaults to ``cuda``; the group is gloo.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from ..elastic import ConfigServer, ShardedElasticTrainer, StepSchedule
from ..launcher import env as E
from ..launcher.watch import watch_run
from ..plan import Cluster, HostList
from ..utils.device import resolve_device
from .ranks import ROOT

ROWS, D_IN, D_OUT = 24, 32, 8       # every size of the schedule divides ROWS


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedule", default="2:5,3:5,1:5,2:5",
                    help="np:steps,... (the cluster size at each step)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the launcher waits for the job")
    E.add_args(ap)
    return ap.parse_args(argv)


def worker(args, we) -> None:
    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    schedule = StepSchedule.parse(args.schedule)
    rng = np.random.RandomState(0)
    x = rng.randn(ROWS, D_IN).astype(np.float32)
    y = x @ rng.randn(D_IN, D_OUT).astype(np.float32)
    batch = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))

    def loss_fn(p, b):
        bx, by = b
        return ((bx @ p["w"] + p["b"] - by) ** 2).mean()

    tr = ShardedElasticTrainer(
        loss_fn, lambda leaves, n: torch.optim.Adam(leaves, lr=args.lr),
        {"w": torch.zeros(D_IN, D_OUT), "b": torch.zeros(D_OUT)}, env=we,
        device=device)
    size = tr.size
    print(f"[rank {tr.rank}] start at step {tr.step_count}: {size} ranks, "
          f"sharded state {tr.local_state_bytes()} B on this rank",
          flush=True)
    while tr.step_count < schedule.total_steps():
        want = schedule.size_at(tr.step_count)
        if tr.rank == 0 and want != tr.size:
            tr.propose_new_size(want)
        loss = tr.step(batch)
        if loss is None:
            print(f"[rank {tr.rank}] detached by a shrink; exiting",
                  flush=True)
            return
        if tr.size != size:
            print(f"[rank {tr.rank}] resized {size} -> {tr.size} (step "
                  f"{tr.step_count}, {tr.last_sync_bytes} B moved)",
                  flush=True)
            size = tr.size
        if tr.rank == 0:
            print(f"step {tr.step_count:3d} ranks={tr.size} "
                  f"loss={loss:.6f}", flush=True)
    p = tr.current_params()
    wsum = float((p["w"].double() ** 2).sum() + (p["b"].double() ** 2).sum())
    print(f"[rank {tr.rank}] done: |w|^2 = {wsum:.9e}", flush=True)
    tr.shutdown()


def launch(args, argv) -> int:
    resolve_device(args.device)             # no card: fail here, not later
    schedule = StepSchedule.parse(args.schedule)
    sizes = [s.size for s in schedule.stages]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    server = ConfigServer().start()
    try:
        with tempfile.TemporaryDirectory(prefix="kft_sharded_") as tmp:
            server.put_cluster(Cluster.from_hostlist(
                HostList.parse(f"127.0.0.1:{max(sizes)}"), sizes[0]))

            def argv_for(rank, cluster, version):
                return [sys.executable, "-m", __spec__.name, *argv,
                        *E.worker_argv(rank, cluster.workers, version,
                                       server.url,
                                       os.path.join(tmp, "rdzv"))]
            exits = watch_run(server, argv_for, tmp, env=env, cwd=str(ROOT),
                              timeout=args.timeout)
            for name in sorted(exits):
                with open(os.path.join(tmp, name + ".log")) as f:
                    sys.stdout.write(f.read())
            print(f"{len(exits)} worker processes, exit codes "
                  f"{sorted(exits.values())}", flush=True)
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
