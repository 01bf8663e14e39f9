"""Peer identity and the peer list (counterpart of kungfu_tpu/plan/peer.py,
cut to what the elastic data plane calls).

A peer is one worker process: ``host:port`` identifies it, ``slot`` is its
index on the host.  In the port each peer is one rank of the data group.
The string forms are the JAX package's, so both packages read each other's
peer lists.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, List


@dataclasses.dataclass(frozen=True, order=True)
class PeerID:
    """Identity of one worker process."""

    host: str
    port: int
    slot: int = 0

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"

    @staticmethod
    def parse(s: str) -> "PeerID":
        """Parse ``host:port[:slot]``."""
        parts = s.split(":")
        if len(parts) == 2:
            return PeerID(parts[0], int(parts[1]))
        if len(parts) == 3:
            return PeerID(parts[0], int(parts[1]), int(parts[2]))
        raise ValueError(f"invalid peer spec: {s!r}")


class PeerList:
    """Ordered list of peers; rank == index."""

    def __init__(self, peers: Iterable[PeerID] = ()):
        self._peers: List[PeerID] = list(peers)

    def __len__(self) -> int:
        return len(self._peers)

    def __iter__(self):
        return iter(self._peers)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PeerList(self._peers[i])
        return self._peers[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PeerList) and self._peers == other._peers

    def __repr__(self) -> str:
        return f"PeerList([{', '.join(map(str, self._peers))}])"

    def rank(self, p: PeerID) -> int:
        """Global rank of ``p``; raises ValueError if absent."""
        return self._peers.index(p)

    def local_rank(self, p: PeerID) -> int:
        """Rank of ``p`` among the peers on its host."""
        r = 0
        for q in self._peers:
            if q == p:
                return r
            if q.host == p.host:
                r += 1
        raise ValueError(f"{p} not in peer list")

    def local_size(self, p: PeerID) -> int:
        return sum(1 for q in self._peers if q.host == p.host)

    def to_string(self) -> str:
        return ",".join(f"{p.host}:{p.port}:{p.slot}" for p in self._peers)

    @staticmethod
    def parse(s: str) -> "PeerList":
        if not s:
            return PeerList()
        return PeerList(PeerID.parse(t) for t in s.split(","))

    def digest(self) -> bytes:
        """Stable digest of the membership (the consensus fence's input)."""
        return hashlib.sha256(self.to_string().encode()).digest()[:16]
