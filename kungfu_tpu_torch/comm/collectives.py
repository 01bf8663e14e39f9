"""Functional collectives over ``torch.distributed`` (counterpart of the
XLA-native half of kungfu_tpu/comm/collectives.py).

Every function takes a tensor, or a dict/list of tensors, and a process
group (None = the default group) in place of the JAX axis name, and
returns new tensors; the inputs are left as they are.  At world size 1
they still call into the group.  The graph-scheduled collectives
(``graph_all_reduce``, ``striped_graph_all_reduce``, ``ring_exchange``)
come with the parallel slice of the port.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.tree import tree_map

OPS = ("SUM", "MIN", "MAX", "PROD", "MEAN")

_REDUCE = {"SUM": dist.ReduceOp.SUM, "MEAN": dist.ReduceOp.SUM,
           "MIN": dist.ReduceOp.MIN, "MAX": dist.ReduceOp.MAX,
           "PROD": dist.ReduceOp.PRODUCT}


def _reduce(t, group, op: str):
    """All-reduce one tensor into a new one.  MEAN is a SUM divided by the
    group size (gloo has no AVG)."""
    if op not in _REDUCE:
        raise ValueError(f"unknown op {op}")
    out = t.clone()
    dist.all_reduce(out, op=_REDUCE[op], group=group)
    if op == "MEAN":
        out = out / dist.get_world_size(group)
    return out


def all_reduce(x, group=None, op: str = "SUM"):
    return tree_map(lambda t: _reduce(t, group, op), x)


def all_gather(x, group=None, axis: int = 0, tiled: bool = False):
    """Every rank's value, stacked along a new ``axis`` (or concatenated
    along it when ``tiled``), in rank order."""
    def gather(t):
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=axis) if tiled else torch.stack(
            parts, dim=axis)
    return tree_map(gather, x)


def reduce_scatter(x, group=None, axis: int = 0):
    """The sum over ranks, split along ``axis``; each rank keeps its own
    block (tiled, as ``lax.psum_scatter(..., tiled=True)``)."""
    def rs(t):
        n = dist.get_world_size(group)
        if t.shape[axis] % n:
            raise ValueError(f"axis {axis} of size {t.shape[axis]} does not "
                             f"split over {n} ranks")
        full = _reduce(t, group, "SUM")
        return full.chunk(n, dim=axis)[dist.get_rank(group)].contiguous()
    return tree_map(rs, x)


def broadcast(x, group=None, root: int = 0):
    """Replicate the value of rank ``root`` (a rank of ``group``) to all
    ranks: the reference's BroadcastGlobalVariables."""
    src = root if group is None else dist.get_global_rank(group, root)

    def bc(t):
        out = t.clone()
        dist.broadcast(out, src=src, group=group)
        return out
    return tree_map(bc, x)


def reduce_to_root(x, group=None, root: int = 0, op: str = "SUM"):
    """Reduce to one rank; other ranks get zeros (reference Reduce)."""
    def rr(t):
        s = _reduce(t, group, op)
        return s if dist.get_rank(group) == root else torch.zeros_like(s)
    return tree_map(rr, x)


def hierarchical_all_reduce(x, inner_group, outer_group, op: str = "SUM"):
    """Two-level all-reduce: over the inner group (a host), then over the
    outer one (across hosts); under MEAN the inner level sums."""
    def h(t):
        t = _reduce(t, inner_group, "SUM" if op == "MEAN" else op)
        return _reduce(t, outer_group, op)
    return tree_map(h, x)
