"""The elastic watcher: keep one process per worker of the config server's
cluster (counterpart of kungfu_tpu/launcher/watch.py, cut to one host).

:func:`watch_run` follows the config server's versions.  At each one it
starts a process, at that version, for every worker of the cluster that
has none; a worker the cluster dropped leaves on its own (its trainer
sees ``detached`` at the fence and the process exits 0) and is reaped.
A worker that a later version adds back while its old process is still
leaving gets a new process once the old one has exited.  The watch ends
when every process has exited.  Each process leads a session of its own,
and on the way out every process group still alive is killed, which
stops whatever a worker started in turn.

Failures.  A worker killed by a signal (exit -15, -9, 143 or 137: a
SIGTERM or SIGKILL) is condemned, never started again, and becomes a
compare-and-swap shrink on the config server (:func:`propose_exclusion`); the survivors, whose collectives
fail, re-form at that version.  Only when removing the dead would empty
the cluster does the job fail.  A config server that cannot be reached
keeps the dead queued for the next poll.  Any other nonzero exit fails
the job at once, with its log tail.  With ``lease_ttl_s`` > 0 a worker
whose liveness lease (``GET /health``) is older than that is taken for
hung: the same exclusion, and the watcher kills its process group; 0
only observes.

Given a :class:`~kungfu_tpu_torch.elastic.config_server.ConfigServer` of
its own process, the watcher subscribes to it and sees every version in
order.  Given a URL it polls, and a version that lives less than one
poll can go unseen: a worker that version drops and the next adds back
is then taken for a survivor, and its new process is never started.

It kills no worker the cluster dropped by a resize: that worker leaves
at its next fence.  Not here: the control port's pushed updates, the
runner's own SIGTERM (evacuating the host), chip pools and the debug
server.
"""
from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import time
import urllib.error
from collections import deque
from typing import (Callable, Dict, Iterable, List, Optional, Set, Tuple,
                    Union)

from ..elastic.config_server import (BACKOFF_BASE_S, BACKOFF_CAP_S,
                                     ConfigServer, fetch_config, fetch_health,
                                     put_config)
from ..plan.cluster import Cluster
from ..plan.peer import PeerID, PeerList

# exit codes of a worker killed by SIGTERM or SIGKILL (negative: the
# signal itself; 128 + N: a shell's report of it)
PREEMPT_CODES = {-15, -9, 143, 137}


class WorkerFailed(RuntimeError):
    """A worker exited with a nonzero code (or the watch timed out)."""


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def propose_exclusion(url: str, dead: Iterable[PeerID], retries: int = 8
                      ) -> Tuple[Optional[int], bool]:
    """Turn dead workers into a shrink: remove them from the cluster of
    the config server at ``url`` by a compare-and-swap, backing off with
    jitter after a lost race (409).  Returns ``(version, removed)``: the
    new version and True, the current version and False when the deaths
    were absorbed already, or ``(None, False)`` when removing them would
    empty the cluster (or ``retries`` races were lost): the caller fails
    the job."""
    dead = set(dead)
    for attempt in range(retries):
        version, cluster = fetch_config(url)
        workers = [w for w in cluster.workers if w not in dead]
        if len(workers) == len(cluster.workers):
            return version, False   # absorbed already
        if not workers:
            return None, False
        try:
            return put_config(url, Cluster(cluster.runners,
                                           PeerList(workers)),
                              if_version=version), True
        except urllib.error.HTTPError as e:
            if e.code != 409:
                raise
        # lost the race to another proposal: back off, fetch again
        time.sleep(random.uniform(0.0, min(BACKOFF_CAP_S,
                                           BACKOFF_BASE_S * 2 ** attempt)))
    return None, False


def watch_run(config: Union[str, ConfigServer],
              argv_for: Callable[[int, Cluster, int], List[str]],
              logs: str, env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None, poll_interval: float = 0.2,
              timeout: Optional[float] = None, lease_ttl_s: float = 0.0,
              exclusions: Optional[list] = None) -> Dict[str, int]:
    """Run the job the config server ``config`` (its ``/config`` URL, or
    the server itself when it runs in this process) describes until every
    worker has exited.

    ``argv_for(rank, cluster, version)`` gives the command line of worker
    ``rank`` of ``cluster`` at ``version`` (with
    :func:`~kungfu_tpu_torch.launcher.env.worker_argv`'s flags).  Worker
    output goes to ``logs/<host>_<port>_v<version>.log``.  Returns
    ``{log name: exit code}``; raises :class:`WorkerFailed` on a nonzero
    exit that is not absorbed (see the module docstring) or past
    ``timeout`` seconds.  ``lease_ttl_s``: see the module docstring.  ``exclusions``: a list the watcher appends one
    record to for each exclusion it made, ``{"version", "removed",
    "cause", "time"}`` (``time.time()`` when the server took it)."""
    url = config.url if isinstance(config, ConfigServer) else config
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
    dead: Dict[PeerID, str] = {}  # killed, to exclude: peer -> its log
    condemned: Set[PeerID] = set()  # never started again at a version
    escalated: Set[PeerID] = set()  # lease exclusions at this version
    escalated_at = -1
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
            if peer not in procs and peer not in condemned:
                spawn(rank, peer)

    def exclude(peers, cause: str) -> bool:
        """Propose the exclusion; False when the config server could not
        be reached (try again at the next poll)."""
        try:
            v, changed = propose_exclusion(url, peers)
        except (OSError, ValueError, KeyError):
            return False
        if v is None:
            logs_of = [dead.get(p) for p in peers if p in dead]
            raise WorkerFailed(
                f"removing {sorted(map(str, peers))} ({cause}) would empty "
                f"the cluster" + "".join(f":\n{_tail(log)}" for log in
                                          logs_of if log))
        if changed:
            print(f"kft-watch: excluded {sorted(map(str, peers))} ({cause}) "
                  f"at version {v}", file=sys.stderr, flush=True)
            if exclusions is not None:
                exclusions.append({"version": v, "cause": cause,
                                   "removed": sorted(map(str, peers)),
                                   "time": time.time()})
        return True

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
                log = os.path.join(logs, names[p.pid] + ".log")
                if code in PREEMPT_CODES:
                    dead[peer] = log
                    waiting.discard(peer)
                    if peer in cluster.workers:
                        condemned.add(peer)
                    continue
                if code != 0:
                    raise WorkerFailed(f"worker {peer} exited {code}:\n"
                                       f"{_tail(log)}")
                if peer in waiting:
                    waiting.discard(peer)
                    spawn(cluster.workers.rank(peer), peer)
            if dead and exclude(list(dead), "killed"):
                dead.clear()
            for v, c in updates():
                if v <= version or c is None:
                    continue
                version, cluster = v, c
                members = set(cluster.workers)
                condemned &= members      # excluded: may come back later
                leaving |= set(procs) - members
                waiting = (waiting | leaving) & members
                spawn_missing()
            if lease_ttl_s > 0 and procs:
                if escalated_at != version:
                    escalated, escalated_at = set(), version
                try:
                    leases = fetch_health(url)["leases"]
                except (OSError, ValueError, KeyError):
                    leases = {}   # the poll tries again
                hung = [peer for peer in procs if peer not in escalated
                        and float(leases.get(f"{peer.host}:{peer.port}", {})
                                  .get("age_s", 0.0)) > lease_ttl_s]
                if hung and exclude(hung, "lease"):
                    escalated |= set(hung)
                    for peer in hung:
                        condemned.add(peer)
                        try:
                            os.killpg(procs[peer].pid, signal.SIGKILL)
                        except ProcessLookupError:
                            pass
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
