"""The data-parallel peer axis as a ``torch.distributed`` process group
(counterpart of kungfu_tpu/comm/mesh.py).

Where the JAX package names a mesh axis, the port passes the process
group of that axis: NCCL on the card, gloo on the CPU.  Nothing here
discovers a cluster; the caller gives the rendezvous, its rank and the
world size (:func:`init_process_group_file`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

PEER_AXIS = "kf_peers"      # flat data-parallel axis


def init_process_group_file(path: str, rank: int, world: int,
                            backend: Optional[str] = None) -> None:
    """Join the default group through a ``FileStore`` at ``path`` (a file
    every rank can reach; no TCP port is taken).  ``backend`` defaults to
    NCCL where CUDA is available, else gloo."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    store = dist.FileStore(path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)


def flat_mesh(n: Optional[int] = None):
    """The process group of the peer axis: the default (world) group, or
    the group of its first ``n`` ranks.  Every rank must call it, as
    ``new_group`` is collective."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group_file "
                           "(or torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if n is None or n == world:
        return dist.group.WORLD
    if n > world:
        raise ValueError(f"requested {n} ranks, have {world}")
    return dist.new_group(list(range(n)))
