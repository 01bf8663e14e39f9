"""The worker's description (counterpart of kungfu_tpu/launcher/env.py).

The JAX launcher hands each worker its identity in variables of the
environment.  The port reads none: the launcher (:mod:`.watch`)
passes it as command-line flags, which the worker parses with
:func:`parse` and installs for the top-level API
(``kungfu_tpu_torch.init``)::

    --kf-rank R --kf-peers h:p:s,h:p:s,... --kf-version V
    [--kf-config-server URL] [--kf-rendezvous DIR]

A process given none of them is a singleton (one rank, no cluster).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence

from ..plan.peer import PeerID, PeerList


@dataclasses.dataclass
class WorkerEnv:
    self_spec: Optional[PeerID]
    peers: PeerList
    cluster_version: int = 0
    config_server: Optional[str] = None
    rendezvous: Optional[str] = None

    @property
    def singleton(self) -> bool:
        return self.self_spec is None

    def rank(self) -> int:
        return 0 if self.singleton else self.peers.rank(self.self_spec)

    def size(self) -> int:
        return max(1, len(self.peers))


SINGLETON = WorkerEnv(None, PeerList())
_installed: WorkerEnv = SINGLETON


def add_args(ap: argparse.ArgumentParser) -> None:
    """The worker flags, for a script that parses its own arguments."""
    ap.add_argument("--kf-rank", type=int, default=None,
                    help="this worker's rank in --kf-peers")
    ap.add_argument("--kf-peers", default="",
                    help="the cluster's workers, host:port:slot,...")
    ap.add_argument("--kf-version", type=int, default=0,
                    help="the cluster version this worker joins")
    ap.add_argument("--kf-config-server", default=None,
                    help="the config server's /config URL")
    ap.add_argument("--kf-rendezvous", default=None,
                    help="a directory for the versioned FileStore "
                         "rendezvous (default: a TCPStore on peer 0)")


def from_args(ns) -> WorkerEnv:
    """The WorkerEnv of parsed flags (see :func:`add_args`)."""
    if ns.kf_rank is None:
        return SINGLETON
    peers = PeerList.parse(ns.kf_peers)
    return WorkerEnv(peers[ns.kf_rank], peers, ns.kf_version,
                     ns.kf_config_server, ns.kf_rendezvous)


def parse(argv: Sequence[str]) -> WorkerEnv:
    """The WorkerEnv of the worker flags in ``argv`` (other arguments are
    ignored)."""
    ap = argparse.ArgumentParser(add_help=False)
    add_args(ap)
    return from_args(ap.parse_known_args(list(argv))[0])


def worker_argv(rank: int, peers: PeerList, version: int,
                config_server: Optional[str] = None,
                rendezvous: Optional[str] = None) -> List[str]:
    """The flags describing worker ``rank`` of ``peers``."""
    argv = ["--kf-rank", str(rank), "--kf-peers", peers.to_string(),
            "--kf-version", str(version)]
    if config_server:
        argv += ["--kf-config-server", config_server]
    if rendezvous:
        argv += ["--kf-rendezvous", rendezvous]
    return argv


def install(we: WorkerEnv) -> WorkerEnv:
    """Make ``we`` this process's description (read by the top-level
    API)."""
    global _installed
    _installed = we
    return we


def installed() -> WorkerEnv:
    return _installed
