"""Functional collectives over ``torch.distributed`` (counterpart of the
XLA-native half of kungfu_tpu/comm/collectives.py).

Every function takes a tensor, or a dict/list of tensors, and a process
group (None = the default group) in place of the JAX axis name, and
returns new tensors; the inputs are left as they are.  At world size 1
they still call into the group.  The graph-scheduled collectives
(``graph_all_reduce``, ``striped_graph_all_reduce``) come with a later
slice of the port.

The differentiable collectives of the parallel envelope
(:func:`ppermute`, :func:`all_to_all`, :func:`copy_to_group`,
:func:`reduce_from_group`, :func:`gather_from_group`) are
``torch.autograd.Function`` s: the
gradient rules that ``shard_map``'s AD gives the JAX package for free.
Their backward passes issue collectives too, so every rank of a group
must run the same graph: autograd then issues them in the same order
everywhere.  :func:`pmax` takes no gradient.
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


def _gather_tiled(t, group):
    """The ranks' ``t`` concatenated along axis 0 in rank order, into one
    new tensor: one ``all_gather_into_tensor``, which NCCL and gloo take
    on CPU and CUDA tensors alike (PERF.md)."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def _reduce_scatter_tiled(t, group):
    """The sum over ranks of ``t`` (leading size divisible by the group
    size), this rank's block of it: one ``reduce_scatter_tensor``, which
    NCCL and gloo take on CPU and CUDA tensors alike (PERF.md)."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, op=dist.ReduceOp.SUM, group=group)
    return out


def reduce_scatter(x, group=None, axis: int = 0):
    """The sum over ranks, split along ``axis``; each rank keeps its own
    block (tiled, as ``lax.psum_scatter(..., tiled=True)``)."""
    def rs(t):
        n = dist.get_world_size(group)
        if t.shape[axis] % n:
            raise ValueError(f"axis {axis} of size {t.shape[axis]} does not "
                             f"split over {n} ranks")
        out = _reduce_scatter_tiled(t.movedim(axis, 0), group)
        return out.movedim(0, axis).contiguous()
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


def ring_exchange(x, group, shift: int, n: int):
    """Send to (rank + shift) mod n, receive from (rank - shift) mod n:
    ``lax.ppermute`` with ``perm=[(i, (i + shift) % n)]``, so rank i's
    value lands at rank i + shift.  The pair-averaging primitive.

    ``n`` is the group size (checked).  The tree goes as one fused buffer
    per dtype in one ``batch_isend_irecv``.  Gloo's point-to-point takes
    CPU tensors only, so on a gloo group a CUDA buffer is staged through
    the host and back."""
    from ..ops import defuse, fuse
    size = dist.get_world_size(group)
    if n != size:
        raise ValueError(f"ring_exchange over {n} ranks on a group of {size}")
    if shift % n == 0:
        return tree_map(lambda t: t.clone(), x)
    me = dist.get_rank(group)
    dst, src = (me + shift) % n, (me - shift) % n
    if group is not None and group is not dist.group.WORLD:
        dst = dist.get_global_rank(group, dst)
        src = dist.get_global_rank(group, src)
    flat, spec = fuse(x)
    staged = dist.get_backend(group) == "gloo"
    sends = {dt: t.cpu() if staged and t.is_cuda else t
             for dt, t in flat.items()}
    recvs = {dt: torch.empty_like(t) for dt, t in sends.items()}
    ops = []
    for dt in sorted(sends):
        ops.append(dist.P2POp(dist.isend, sends[dt], dst, group))
        ops.append(dist.P2POp(dist.irecv, recvs[dt], src, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return defuse({dt: r.to(flat[dt].device) for dt, r in recvs.items()},
                  spec)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift: int):
        ctx.group, ctx.shift = group, shift
        n = dist.get_world_size(group)
        return ring_exchange(x, group, shift, n)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return ring_exchange(g.contiguous(), ctx.group, -ctx.shift, n), \
            None, None


def ppermute(x, group, shift: int = 1):
    """Rank i's ``x`` lands at rank (i + shift) mod n: ``lax.ppermute``
    with ``perm=[(i, (i + shift) % n)]``.  Its gradient is the reverse
    shift, as JAX's transpose of ppermute is."""
    return _PPermute.apply(x, group, shift)


def _all_to_all(x, group, split_axis: int, concat_axis: int):
    n = dist.get_world_size(group)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {n} ranks")
    if n == 1:
        return x.clone()
    xs = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)   # gloo takes CUDA too
    rest = xs.shape[1:]
    # block j came from rank j: [n, c, rest] -> the split axis back in
    # place, then the blocks concatenated along concat_axis in rank order
    y = out.reshape(n, xs.shape[0] // n, *rest).movedim(1, split_axis + 1)
    y = y.movedim(0, concat_axis)
    shape = list(y.shape)
    shape[concat_axis:concat_axis + 2] = [shape[concat_axis]
                                          * shape[concat_axis + 1]]
    return y.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis: int, concat_axis: int):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, concat_axis, split_axis), None, None, \
            None


def all_to_all(x, group, split_axis: int, concat_axis: int):
    """Tiled all-to-all, as ``lax.all_to_all(..., tiled=True)``: ``x`` is
    cut into n blocks along ``split_axis``, block j goes to rank j, and
    the blocks a rank receives are concatenated along ``concat_axis`` in
    rank order.  Its gradient is the inverse exchange."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group, "SUM"), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group, "SUM")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x, group):
    """Megatron's "copy to tensor-parallel region": the identity forward,
    an all-reduce (sum) of the gradient backward.  It stands where a
    replicated activation enters a sharded product, where shard_map's AD
    sums the cotangent over the axis in JAX."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """Megatron's "reduce from tensor-parallel region": an all-reduce
    (sum) forward, the identity backward (``lax.psum`` of a value that
    varies over the axis; its cotangent is the same on every rank)."""
    return _ReduceFromGroup.apply(x, group)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_tiled(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_tiled(g, ctx.group), None


def gather_from_group(x, group):
    """The tiled all-gather of ZeRO-3: every rank's ``x`` concatenated
    along axis 0 in rank order (``lax.all_gather(..., axis=0,
    tiled=True)``), whose gradient is the summing reduce-scatter: each
    rank gets its block of the sum of the ranks' cotangents, the
    transpose that shard_map's AD gives the gather in JAX."""
    return _GatherFromGroup.apply(x, group)


def pmax(x, group):
    """The elementwise max over the group, of detached values (``lax.pmax``
    has no gradient rule; callers take it of stopped values)."""
    return _reduce(x.detach(), group, "MAX")
