"""Tensor-level ops: fusion, grouped collectives, peer info
(counterpart of kungfu_tpu/ops/__init__.py).  The kernels live in the
submodules (flash_attention, paged_attention, chunked_ce)."""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..comm import collectives as C
from ..utils.tree import tree_leaves, tree_map


def fuse(tensors):
    """Flatten a tree into one flat vector per dtype plus its spec, so a
    collective runs once per dtype (no silent casting)."""
    leaves = tree_leaves(tensors)
    groups: dict = {}
    for i, t in enumerate(leaves):
        groups.setdefault(str(t.dtype), []).append(i)
    flat = {dt: torch.cat([leaves[i].reshape(-1) for i in idxs])
            for dt, idxs in groups.items()}
    shapes = [tuple(t.shape) for t in leaves]
    return flat, (tensors, shapes, groups)


def defuse(flat, spec):
    """Inverse of :func:`fuse`."""
    template, shapes, groups = spec
    leaves = [None] * len(shapes)
    for dt, idxs in groups.items():
        off, vec = 0, flat[dt]
        for i in idxs:
            size = 1
            for d in shapes[i]:
                size *= d
            leaves[i] = vec[off:off + size].reshape(shapes[i])
            off += size
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def group_all_reduce(tensors, group=None, op: str = "SUM"):
    """Per-tensor all-reduce of a tree (reference group_all_reduce)."""
    return C.all_reduce(tensors, group, op)


def fused_all_reduce(tensors, group=None, op: str = "SUM"):
    """Fuse a tree, all-reduce once per dtype, defuse."""
    flat, spec = fuse(tensors)
    return defuse(C.all_reduce(flat, group, op), spec)


def monitored_all_reduce(tensor, group=None, op: str = "SUM"):
    """All-reduce that also returns the bytes it moved (reference
    KungfuMonitoredAllReduce)."""
    out = C.all_reduce(tensor, group, op)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(tensor))
    return out, nbytes


def rank(group=None) -> int:
    return dist.get_rank(group)


def cluster_size(group=None) -> int:
    return dist.get_world_size(group)


def peer_info(group=None):
    """(rank, cluster_size) (reference KungfuGetPeerInfo)."""
    return rank(group), cluster_size(group)
