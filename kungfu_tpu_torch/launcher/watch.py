"""The elastic watcher: keep one process per worker of the config server's
cluster (counterpart of kungfu_tpu/launcher/watch.py, cut to one host).

:func:`watch_run` follows the config server's versions.  At each one it
starts a process, at that version, for every worker of the cluster that
has none; a worker the cluster dropped leaves on its own (its trainer
sees ``detached`` at the fence and the process exits 0) and is reaped.
A worker that a later version adds back while its old process is still
leaving gets a new process once the old one has exited.  A process that
exits with another code fails the job at once, with its log tail.  The
watch ends when every process has exited.  Each process leads a session
of its own, and on the way out every process group still alive is
killed, which stops whatever a worker started in turn.

Given a :class:`~kungfu_tpu_torch.elastic.config_server.ConfigServer` of
its own process, the watcher subscribes to it and sees every version in
order.  Given a URL it polls, and a version that lives less than one
poll can go unseen: a worker that version drops and the next adds back
is then taken for a survivor, and its new process is never started.

Unlike the JAX watcher it kills no worker the cluster dropped: a worker
killed mid-collective would hang or fail the survivors' ``torch.distributed``
group, where the JAX runtime recovers.  Not here: the control port's
pushed updates, preemption, chip pools, leases and the debug server.
"""
from __future__ import annotations

import os
import signal
import subprocess
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

from ..elastic.config_server import ConfigServer, fetch_config
from ..plan.cluster import Cluster
from ..plan.peer import PeerID


class WorkerFailed(RuntimeError):
    """A worker exited with a nonzero code (or the watch timed out)."""


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def watch_run(config: Union[str, ConfigServer],
              argv_for: Callable[[int, Cluster, int], List[str]],
              logs: str, env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None, poll_interval: float = 0.2,
              timeout: Optional[float] = None) -> Dict[str, int]:
    """Run the job the config server ``config`` (its ``/config`` URL, or
    the server itself when it runs in this process) describes until every
    worker has exited.

    ``argv_for(rank, cluster, version)`` gives the command line of worker
    ``rank`` of ``cluster`` at ``version`` (with
    :func:`~kungfu_tpu_torch.launcher.env.worker_argv`'s flags).  Worker
    output goes to ``logs/<host>_<port>_v<version>.log``.  Returns
    ``{log name: exit code}``; raises :class:`WorkerFailed` on a nonzero
    exit or past ``timeout`` seconds."""
    unsubscribe = None
    if isinstance(config, ConfigServer):
        pushed: deque = deque()
        version, cluster, unsubscribe = config.subscribe(
            lambda v, c: pushed.append((v, c)))

        def updates() -> List[Tuple[int, Optional[Cluster]]]:
            got = []
            while pushed:
                got.append(pushed.popleft())
            return got
        if cluster is None:
            unsubscribe()
            raise ValueError("the config server holds no cluster")
    else:
        version, cluster = fetch_config(config, deadline=30.0,
                                        retry_unseeded=True)

        def updates() -> List[Tuple[int, Optional[Cluster]]]:
            try:
                return [fetch_config(config)]
            except (OSError, ValueError, KeyError):
                return []             # a transient failure: poll again
    procs: Dict[PeerID, subprocess.Popen] = {}
    leaving: Set[PeerID] = set()  # dropped by a version, process alive
    waiting: Set[PeerID] = set()  # added back while leaving: spawn at exit
    names: Dict[int, str] = {}
    exits: Dict[str, int] = {}
    files = []
    deadline = None if timeout is None else time.monotonic() + timeout

    def spawn(rank: int, peer: PeerID) -> None:
        name = f"{peer.host}_{peer.port}_v{version}"
        out = open(os.path.join(logs, name + ".log"), "w")
        files.append(out)
        p = subprocess.Popen(argv_for(rank, cluster, version), env=env,
                             cwd=cwd, stdout=out, stderr=subprocess.STDOUT,
                             start_new_session=True)
        procs[peer], names[p.pid] = p, name

    def spawn_missing() -> None:
        for rank, peer in enumerate(cluster.workers):
            if peer not in procs:
                spawn(rank, peer)

    try:
        spawn_missing()
        while procs:
            for peer, p in list(procs.items()):
                code = p.poll()
                if code is None:
                    continue
                del procs[peer]
                leaving.discard(peer)
                exits[names[p.pid]] = code
                if code != 0:
                    log = os.path.join(logs, names[p.pid] + ".log")
                    raise WorkerFailed(f"worker {peer} exited {code}:\n"
                                       f"{_tail(log)}")
                if peer in waiting:
                    waiting.discard(peer)
                    spawn(cluster.workers.rank(peer), peer)
            for v, c in updates():
                if v <= version or c is None:
                    continue
                version, cluster = v, c
                members = set(cluster.workers)
                leaving |= set(procs) - members
                waiting = (waiting | leaving) & members
                spawn_missing()
            if deadline is not None and time.monotonic() > deadline:
                raise WorkerFailed(f"watch timed out after {timeout} s with "
                                   f"{sorted(map(str, procs))} running")
            time.sleep(poll_interval)
        return exits
    finally:
        if unsubscribe is not None:
            unsubscribe()
        for p in procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        for f in files:
            f.close()
