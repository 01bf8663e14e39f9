"""One process per rank for the examples.

``python -m kungfu_tpu_torch.examples.<name> --world N`` starts N copies
of itself, each with ``--rank r --store <file>``, and waits for them; the
copies join the default group through a ``FileStore`` at that file
(:func:`~kungfu_tpu_torch.comm.mesh.init_process_group_file`).  If a
rank fails, the others are stopped and the exit code is the failing
rank's.

The backend defaults to NCCL on ``cuda`` and gloo on ``cpu``.  NCCL
refuses two ranks on one GPU, so more ranks than cards need
``--backend gloo``.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..comm.mesh import init_process_group_file
from ..utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]     # holds kungfu_tpu_torch/


def add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--world", type=int, default=1,
                    help="number of ranks (processes)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)


def launch(argvs, env=None, cwd=None, timeout: float = None, logs=None,
           sessions: bool = False):
    """Run one process per argv and wait for them all.  Returns ``(i,
    code)`` for the first process to fail (``code`` None: ``timeout``
    seconds passed first), else ``(None, 0)``; the processes still
    running are killed on the way out.  ``logs``: process i writes its
    output to ``logs/<i>.log``.  ``sessions``: each process leads a
    session of its own and its whole process group is killed, which
    stops the processes it started in turn (a launcher's ranks)."""
    procs, files = [], []
    try:
        for i, argv in enumerate(argvs):
            out = None
            if logs is not None:
                out = open(os.path.join(logs, f"{i}.log"), "w")
                files.append(out)
            procs.append(subprocess.Popen(
                argv, env=env, cwd=cwd, stdout=out,
                stderr=None if out is None else subprocess.STDOUT,
                start_new_session=sessions))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                return bad[0], codes[bad[0]]
            if all(c == 0 for c in codes):
                return None, 0
            if deadline is not None and time.monotonic() > deadline:
                return codes.index(None), None
            time.sleep(0.2)
    finally:
        for p in procs:
            if sessions:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            elif p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()


def spawn(module: str, argv, world: int) -> int:
    """Run ``python -m module *argv --rank r --store <file>`` for every
    rank and wait; a rank that fails stops the others and gives the exit
    code."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    with tempfile.TemporaryDirectory() as tmp:
        _, code = launch(
            [[sys.executable, "-m", module, *argv, "--rank", str(r),
              "--store", os.path.join(tmp, "store")] for r in range(world)],
            env)
    return code


def rank_device(args) -> torch.device:
    """The rank's device: ``cpu`` (with an equal share of the cores), or
    card ``rank mod count``."""
    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))
    elif device.index is None:
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def main(module: str, args, argv, body) -> int:
    """Without ``--rank``: start the ranks (:func:`spawn`).  With it: join
    the group, run ``body(args, device)`` and leave the group."""
    if args.rank is None:
        return spawn(module, argv, args.world)
    device = rank_device(args)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    init_process_group_file(args.store, args.rank, args.world, backend)
    try:
        body(args, device)
    finally:
        dist.destroy_process_group()
    return 0
