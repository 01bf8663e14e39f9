"""Snapshots of device state to the host, pipelined (the ``dispatch`` /
``join`` / ``snapshot`` core of kungfu_tpu/elastic/snapshot.py).

:func:`dispatch` starts every leaf's device-to-host copy before waiting on
any: on the card each CUDA tensor is copied ``non_blocking`` into a pinned
host buffer on a side stream that first waits on the current one (so the
copies see the state as the step left it, and overlap each other and the
work queued after them); one event is recorded after the last copy, and
:meth:`PendingSnapshot.join` waits on it.  CPU tensors are cloned, and
other leaves pass through.  :func:`snapshot` is dispatch then join, for a
caller that needs the host tree now (a checkpoint).  The resize path needs
none: a ``torch.distributed`` teardown invalidates no tensor.  The
background committer (``AsyncCommitter``) comes with failure recovery.
"""
from __future__ import annotations

import torch

from ..utils.tree import tree_leaves, tree_map

__all__ = ["PendingSnapshot", "dispatch", "snapshot"]


class PendingSnapshot:
    """A dispatched but not yet joined device-to-host snapshot.  It holds
    the host buffers the copies land in; ``join()`` waits for them and
    returns the host tree."""

    __slots__ = ("_tree", "_event", "_sources")

    def __init__(self, tree, event, sources):
        self._tree = tree
        self._event = event
        self._sources = sources

    def join(self):
        """Wait for every copy and return the host tree."""
        if self._event is not None:
            self._event.synchronize()
        # the copies are done: the device tensors may be freed or reused
        self._event = self._sources = None
        return self._tree


def dispatch(tree) -> PendingSnapshot:
    """Start the host copy of every tensor of ``tree`` and return at once
    (see the module docstring)."""
    stream = event = None
    sources = []

    def copy(leaf):
        nonlocal stream
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if not leaf.is_cuda:
            return leaf.detach().clone()
        if stream is None:
            stream = torch.cuda.Stream(device=leaf.device)
            stream.wait_stream(torch.cuda.current_stream(leaf.device))
        host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(leaf.detach(), non_blocking=True)
        # the source must outlive the copy on the side stream
        sources.append(leaf)
        return host

    out = tree_map(copy, tree)
    if stream is not None:
        event = torch.cuda.Event()
        event.record(stream)
    return PendingSnapshot(out, event, sources)


def snapshot(tree):
    """The host tree of ``tree`` now: :func:`dispatch`, then join."""
    return dispatch(tree).join()


def tree_nbytes(tree) -> int:
    """Bytes of the tensors of a tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))
