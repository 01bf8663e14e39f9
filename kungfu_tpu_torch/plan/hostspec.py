"""Host specifications and host lists (counterpart of
kungfu_tpu/plan/hostspec.py, cut to what the elastic data plane calls).

A host spec is ``ip[:slots[:public_addr]]``; a host list is a
comma-separated sequence of them.  The JAX package moves its default
worker port with a variable of the environment; the port reads none, so
the default is the JAX package's default and callers pass another base.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List

from .peer import PeerID, PeerList

DEFAULT_WORKER_PORT = 31100
DEFAULT_RUNNER_PORT = DEFAULT_WORKER_PORT - 100


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One host: internal address, worker slots, public address."""

    host: str
    slots: int = 1
    public_addr: str = ""

    def __post_init__(self):
        if not self.public_addr:
            object.__setattr__(self, "public_addr", self.host)
        if self.slots < 0:
            raise ValueError(f"negative slots on {self.host}")

    @staticmethod
    def parse(s: str) -> "HostSpec":
        parts = s.split(":")
        if len(parts) == 1:
            return HostSpec(parts[0])
        if len(parts) == 2:
            return HostSpec(parts[0], int(parts[1]))
        if len(parts) == 3:
            return HostSpec(parts[0], int(parts[1]), parts[2])
        raise ValueError(f"invalid host spec: {s!r}")

    def __str__(self) -> str:
        return f"{self.host}:{self.slots}:{self.public_addr}"


class HostList:
    """Ordered list of hosts with slot capacities."""

    def __init__(self, specs: Iterable[HostSpec] = ()):
        self._specs: List[HostSpec] = list(specs)

    def __len__(self) -> int:
        return len(self._specs)

    def __iter__(self):
        return iter(self._specs)

    def __getitem__(self, i) -> HostSpec:
        return self._specs[i]

    @staticmethod
    def parse(s: str) -> "HostList":
        if not s:
            return HostList()
        return HostList(HostSpec.parse(t) for t in s.split(","))

    def cap(self) -> int:
        return sum(h.slots for h in self._specs)

    def gen_peer_list(self, np: int,
                      base_port: int = DEFAULT_WORKER_PORT) -> PeerList:
        """The first ``np`` worker slots, filling each host before the
        next."""
        if np > self.cap():
            raise ValueError(f"np={np} exceeds capacity {self.cap()}")
        peers = []
        for h in self._specs:
            for slot in range(h.slots):
                if len(peers) == np:
                    return PeerList(peers)
                peers.append(PeerID(h.host, base_port + slot, slot))
        return PeerList(peers)

    def gen_runner_list(self, port: int = DEFAULT_RUNNER_PORT) -> PeerList:
        """One runner endpoint per host."""
        return PeerList(PeerID(h.host, port, 0) for h in self._specs)
