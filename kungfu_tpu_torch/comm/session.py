"""A communication session over one membership version: the eager core of
kungfu_tpu/comm/session.py that the elastic trainers call (``size``,
``rank``, ``barrier``, ``bytes_consensus``, ``all_reduce``).

The JAX session runs its collectives over a device mesh; here a session
wraps a ``torch.distributed`` group (None = the default group) and the
cluster version at which that group was formed.  The graph strategies and
``auto_adapt`` come with the parallel slice of the port.
"""
from __future__ import annotations

import hashlib

import torch
import torch.distributed as dist

from .. import distributed as D
from . import collectives as C

_OPS = ("SUM", "MAX", "MIN")


class Session:
    """Collectives over ``group`` at membership ``version``."""

    def __init__(self, group=None, version: int = 0):
        self.group = group
        self.version = version

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def barrier(self) -> None:
        D.barrier(self.group)

    def all_reduce(self, x, op: str = "SUM"):
        """A new tensor (or tree of them) reduced over the group by
        ``op`` (SUM, MAX or MIN); integers stay exact."""
        if op not in _OPS:
            raise ValueError(f"unknown op {op}")
        return C.all_reduce(x, self.group, op)

    def consensus(self, x: torch.Tensor) -> bool:
        """True iff every rank holds bit-identical ``x``: an all-reduce MIN
        and MAX of its bytes as integers, compared."""
        v = x.detach().contiguous().reshape(-1).view(torch.uint8).to(
            torch.int32).to(D.comm_device(self.group))
        lo = C.all_reduce(v, self.group, "MIN")
        hi = C.all_reduce(v, self.group, "MAX")
        return bool(torch.equal(lo, hi))

    def bytes_consensus(self, payload: bytes) -> bool:
        """Consensus over a byte string this process contributes (the
        fence on a cluster change): its SHA-256 digest goes through
        :meth:`consensus`."""
        digest = hashlib.sha256(payload).digest()
        return self.consensus(torch.frombuffer(bytearray(digest),
                                               dtype=torch.uint8))
