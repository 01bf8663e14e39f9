"""The cluster, the unit of elastic membership (counterpart of
kungfu_tpu/plan/cluster.py).

A cluster is a pair (runners, workers).  ``resize(n)`` keeps a prefix of
the workers or grows one worker at a time onto the least-loaded runner
host.  The JSON codec is the config server's wire schema, byte for byte
the JAX package's, so the two packages' clients and servers interoperate.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List

from .hostspec import DEFAULT_WORKER_PORT, HostList
from .peer import PeerID, PeerList


@dataclasses.dataclass
class Cluster:
    runners: PeerList
    workers: PeerList

    def validate(self) -> None:
        """Every worker must live on a host that has a runner."""
        runner_hosts = {r.host for r in self.runners}
        for w in self.workers:
            if w.host not in runner_hosts:
                raise ValueError(f"worker {w} has no runner on its host")
        if len(set(self.workers)) != len(self.workers):
            raise ValueError("duplicate workers")

    def size(self) -> int:
        return len(self.workers)

    def resize(self, new_size: int) -> "Cluster":
        """Shrink: keep the prefix of the workers; grow: add workers one at
        a time on the least-loaded runner host."""
        if new_size < 0:
            raise ValueError("negative cluster size")
        if new_size <= len(self.workers):
            return Cluster(self.runners, self.workers[:new_size])
        workers = list(self.workers)
        while len(workers) < new_size:
            workers.append(self._grow_one(workers))
        return Cluster(self.runners, PeerList(workers))

    def _grow_one(self, workers: List[PeerID]) -> PeerID:
        load = {r.host: 0 for r in self.runners}
        used_ports = {}
        for w in workers:
            load[w.host] = load.get(w.host, 0) + 1
            used_ports.setdefault(w.host, set()).add(w.port)
        if not load:
            raise ValueError("cannot grow: no runners")
        host = min(load, key=lambda h: (load[h], list(load).index(h)))
        # the port base comes from the cluster's own workers: a grown
        # worker's slot is its port minus the base
        bases = sorted({w.port - w.slot for w in workers})
        if len(bases) > 1:
            raise ValueError(f"cluster workers derive different port bases "
                             f"{bases}; slot arithmetic would collide")
        base = bases[0] if bases else DEFAULT_WORKER_PORT
        port = base
        while port in used_ports.get(host, ()):
            port += 1
        return PeerID(host, port, port - base)

    def to_json(self) -> str:
        return json.dumps({
            "runners": [str(r) for r in self.runners],
            "workers": [f"{w.host}:{w.port}:{w.slot}" for w in self.workers],
        })

    @staticmethod
    def from_json(s: str) -> "Cluster":
        d = json.loads(s)
        return Cluster(
            runners=PeerList(PeerID.parse(r) for r in d["runners"]),
            workers=PeerList(PeerID.parse(w) for w in d["workers"]),
        )

    def digest(self) -> bytes:
        """Stable digest for the consensus fence on cluster changes."""
        return hashlib.sha256(self.to_json().encode()).digest()[:16]

    @staticmethod
    def from_hostlist(hl: HostList, np: int,
                      base_port: int = DEFAULT_WORKER_PORT) -> "Cluster":
        return Cluster(runners=hl.gen_runner_list(),
                       workers=hl.gen_peer_list(np, base_port=base_port))
