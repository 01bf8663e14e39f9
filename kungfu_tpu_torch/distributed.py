"""Lifecycle of the multi-process data plane, a ``torch.distributed``
default group (counterpart of kungfu_tpu/distributed.py).

A resize re-forms the data group across processes at a new cluster
version.  The rendezvous is *versioned*: version ``v`` meets at a store of
its own, so a stale process cannot meet the new membership (the fencing
token of the JAX package's versioned coordinator):

- a ``FileStore`` at ``<rendezvous>/v<v>`` when the caller gives a
  directory every member can reach (no TCP port is taken);
- else a ``TCPStore`` hosted by rank 0 at :func:`coordinator_address`,
  peer 0's worker port + 1000 + v, derived by every member from the
  shared peer list, as the JAX package derives its coordinator.

Unlike ``jax.distributed``, tearing the group down invalidates no tensor,
so a resize needs no snapshot to the host: survivors keep their replica
where it lies.  State moves over the group itself
(:func:`broadcast_tree`), since a new process may join a collective
before it holds the model.  The backend defaults to NCCL on CUDA and gloo
otherwise; NCCL refuses two ranks on one card, so several ranks sharing a
card pass ``backend="gloo"`` (gloo stages CUDA tensors through the host).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .utils.tree import tree_leaves, tree_map

_COORD_PORT_OFFSET = 1000
_VERSION_WRAP = 20000

# (version, backend, world size, rank, TCP rendezvous?) of the live group,
# None when down
_live: Optional[Tuple[int, str, int, int, bool]] = None


def _norm_peers(peers: Sequence) -> List[Tuple[str, int]]:
    out = []
    for p in peers:
        if isinstance(p, str):
            host, port = p.split(":")[:2]
            out.append((host, int(port)))
        else:
            out.append((p.host, int(p.port)))
    return out


def coordinator_address(peers: Sequence, version: int) -> str:
    """The version-``v`` rendezvous endpoint: peer 0's host at its worker
    port + 1000 + v, folded into the unprivileged port range.  Distinct
    versions map to distinct ports for 20000 consecutive versions."""
    host, port = _norm_peers(peers)[0]
    raw = port + _COORD_PORT_OFFSET + (version % _VERSION_WRAP)
    return f"{host}:{1024 + (raw - 1024) % (65536 - 1024)}"


def version() -> Optional[int]:
    """Cluster version of the live data group, or None when down."""
    return _live[0] if _live is not None else None


def is_initialized() -> bool:
    return _live is not None


def initialize(peers: Sequence, rank: int, cluster_version: int = 0,
               rendezvous: Optional[str] = None,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Join the version-``cluster_version`` data group as ``rank`` of
    ``len(peers)``.  Every member calls it with the same peers, version
    and rendezvous; it returns once all of them have met.  ``backend``:
    None picks NCCL when CUDA is available, else gloo."""
    global _live
    n = len(_norm_peers(peers))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if _live is not None:
        if _live[0] == cluster_version and _live[2] == n:
            return
        raise RuntimeError(
            f"data group live at version {_live[0]}; call reinit() (or "
            f"shutdown() first) to move to version {cluster_version}")
    timeout = datetime.timedelta(seconds=timeout_s)
    if rendezvous is not None:
        os.makedirs(rendezvous, exist_ok=True)
        store = dist.FileStore(os.path.join(rendezvous,
                                            f"v{cluster_version}"), n)
    else:
        host, port = coordinator_address(peers, cluster_version).rsplit(
            ":", 1)
        store = dist.TCPStore(host, int(port), n, is_master=rank == 0,
                              timeout=timeout)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=timeout)
    _live = (int(cluster_version), backend, n, rank, rendezvous is None)


def shutdown() -> None:
    """Leave the data group (local: no collective)."""
    global _live
    if _live is None:
        return
    dist.destroy_process_group()
    _live = None


def reinit(peers: Sequence, rank: int, cluster_version: int,
           rendezvous: Optional[str] = None,
           backend: Optional[str] = None) -> bool:
    """Move the data group to a new cluster version: leave the old one
    and join the new.  Returns True when a rebuild happened."""
    if _live is not None and _live[0] == cluster_version:
        return False
    shutdown()
    initialize(peers, rank, cluster_version, rendezvous, backend)
    return True


def shutdown_ordered(grace_s: float = 3.0, timeout_s: float = 30.0) -> None:
    """End-of-job teardown: a barrier, so every member arrives with the
    group intact, then every rank leaves; with a TCP rendezvous rank 0
    leaves last, after ``grace_s``, as its store serves the others.  The
    barrier waits at most ``timeout_s``: a member that never comes (it
    crashed) must not hang the rest; then this returns without leaving,
    and process exit drops the connections."""
    if _live is None:
        return
    snap = _live
    done = threading.Event()

    def _barrier():
        barrier()
        done.set()

    t = threading.Thread(target=_barrier, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if not done.is_set():
        return
    if snap[4] and snap[3] == 0 and snap[2] > 1:
        time.sleep(grace_s)
    shutdown()


def comm_device(group=None) -> torch.device:
    """Where small control tensors of a collective live: the current card
    for NCCL, the host for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(group=None) -> None:
    """A rendezvous of the group: a one-element all-reduce, waited on."""
    x = torch.ones(1, device=comm_device(group))
    dist.all_reduce(x, group=group)
    x.item()


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What a receiver of :func:`broadcast_tree` learns of one leaf: a
    tensor's shape, dtype and device kind, or a plain value."""

    shape: Optional[tuple] = None
    dtype: Optional[torch.dtype] = None
    device: str = ""
    value: object = None


def _spec(leaf) -> _Spec:
    if isinstance(leaf, torch.Tensor):
        return _Spec(tuple(leaf.shape), leaf.dtype, leaf.device.type)
    return _Spec(value=leaf)


def broadcast_tree(tree, group=None, root: int = 0):
    """Broadcast a tree of tensors (dicts, lists and tuples; other leaves
    are plain values) from ``root``, a rank of ``group``, to every rank
    of it.  The counterpart of the JAX package's ``broadcast_host_tree``,
    over the data group instead of a host plane.

    The root sends the tree's structure first (``broadcast_object_list``:
    shapes, dtypes, device kinds and the plain values), so a receiver
    passes anything (None) and needs no template: a new rank can receive
    an optimizer's state before it has any.  The tensors then go as one
    fused buffer per (device kind, dtype): on NCCL through the card, on
    gloo where they lie.  Returns the root's tree on every rank; the
    root gets its own tensors back, a receiver views of one buffer per
    (device kind, dtype), on the device kind the root's lay on (the
    current card for ``cuda``)."""
    src = root if group is None else dist.get_global_rank(group, root)
    me = dist.get_rank(group)
    obj = [tree_map(_spec, tree) if me == root else None]
    dist.broadcast_object_list(obj, src=src, group=group)
    specs = [s for s in tree_leaves(obj[0]) if s.dtype is not None]
    if me == root:
        leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    buffers = {}                 # (device kind, dtype) -> leaf indices
    for i, s in enumerate(specs):
        buffers.setdefault((s.device, str(s.dtype)), []).append(i)
    nccl = dist.get_backend(group) == "nccl"
    out = [None] * len(specs)
    for (kind, _), idxs in sorted(buffers.items()):
        sizes = [math.prod(specs[i].shape) for i in idxs]
        if me == root:
            buf = torch.cat([leaves[i].reshape(-1) for i in idxs])
        else:
            buf = torch.empty(sum(sizes), dtype=specs[idxs[0]].dtype,
                              device=_device(kind))
        wire = buf.to(comm_device(group)) if nccl and not buf.is_cuda else buf
        dist.broadcast(wire, src=src, group=group)
        if me != root:
            buf = wire.to(buf.device)
            for i, part in zip(idxs, buf.split(sizes)):
                out[i] = part.view(specs[i].shape)
    if me == root:
        return tree
    it = iter(out)
    return tree_map(lambda s: next(it) if s.dtype is not None else s.value,
                    obj[0])


def _device(kind: str) -> torch.device:
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)
