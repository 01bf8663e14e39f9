"""Snapshots of device state to the host, pipelined, and the background
committer (counterpart of kungfu_tpu/elastic/snapshot.py).

:func:`dispatch` starts every leaf's device-to-host copy before waiting on
any: on the card each CUDA tensor is copied ``non_blocking`` into a pinned
host buffer on a side stream that first waits on the current one (so the
copies see the state as the step left it, and overlap each other and the
work queued after them); one event is recorded after the last copy, and
:meth:`PendingSnapshot.join` waits on it.  CPU tensors are cloned, and
other leaves pass through.  :func:`snapshot` is dispatch then join, for a
caller that needs the host tree now (a checkpoint).

Unlike a JAX array, a torch tensor is written in place: the next
``optimizer.step()`` overwrites the parameters and moments a dispatched
copy is still reading, on another stream.  Before such a write the
writer calls :meth:`PendingSnapshot.fence` (or
:meth:`AsyncCommitter.fence`), which makes its stream wait on the copies'
event; without it a commit can tear.

:class:`AsyncCommitter` moves the join off the step: ``initiate``
dispatches, and a thread joins and publishes.  Its pinned buffers are
reused from one commit to the next: two sets, the published commit's and
the one being written.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from ..utils.tree import tree_leaves, tree_map

__all__ = ["PendingSnapshot", "AsyncCommitter", "dispatch", "snapshot",
           "tree_nbytes"]


class PendingSnapshot:
    """A dispatched but not yet joined device-to-host snapshot.  It holds
    the host buffers the copies land in; ``join()`` waits for them and
    returns the host tree.  ``dispatch_s``: seconds the dispatch took
    (what the caller's thread paid); ``join_s``: the wait in ``join``;
    ``nbytes``: the bytes of its tensors."""

    __slots__ = ("_tree", "_event", "_device", "_sources", "dispatch_s",
                 "join_s", "nbytes")

    def __init__(self, tree, event, sources, dispatch_s: float = 0.0,
                 device=None):
        self._tree = tree
        self._event = event
        self._device = device
        self._sources = sources
        self.dispatch_s = dispatch_s
        self.join_s = 0.0
        self.nbytes = tree_nbytes(tree)

    def fence(self) -> None:
        """Make the current CUDA stream (of the copies' device) wait until
        the copies are done: call before writing in place to a tensor
        this snapshot reads."""
        event, device = self._event, self._device
        if event is not None:
            torch.cuda.current_stream(device).wait_event(event)

    def join(self):
        """Wait for every copy and return the host tree."""
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        self.join_s = time.perf_counter() - t0
        # the copies are done: the device tensors may be freed or reused
        self._event = self._sources = None
        return self._tree


def _reusable(host, leaf) -> bool:
    return (isinstance(host, torch.Tensor) and host.is_pinned()
            and host.shape == leaf.shape and host.dtype == leaf.dtype)


def dispatch(tree, into=None) -> PendingSnapshot:
    """Start the host copy of every tensor of ``tree`` and return at once
    (see the module docstring).  ``into``: the host tree of an earlier
    snapshot of a tree of the same structure, whose pinned buffers the
    copies of CUDA tensors may overwrite (a leaf that does not match in
    shape and dtype gets a new buffer)."""
    t0 = time.perf_counter()
    stream = event = None
    sources = []
    spare = tree_leaves(into) if into is not None else []
    if len(spare) != len(tree_leaves(tree)):
        spare = []
    spare = iter(spare)

    def copy(leaf):
        nonlocal stream
        old = next(spare, None)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if not leaf.is_cuda:
            return leaf.detach().clone()
        if stream is None:
            stream = torch.cuda.Stream(device=leaf.device)
            stream.wait_stream(torch.cuda.current_stream(leaf.device))
        host = old if _reusable(old, leaf) else torch.empty(
            leaf.shape, dtype=leaf.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(leaf.detach(), non_blocking=True)
        # the source must outlive the copy on the side stream
        sources.append(leaf)
        return host

    out = tree_map(copy, tree)
    if stream is not None:
        event = torch.cuda.Event()
        event.record(stream)
    return PendingSnapshot(out, event, sources, time.perf_counter() - t0,
                           stream and stream.device)


def snapshot(tree):
    """The host tree of ``tree`` now: :func:`dispatch`, then join."""
    return dispatch(tree).join()


def tree_nbytes(tree) -> int:
    """Bytes of the tensors of a tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class AsyncCommitter:
    """Double-buffered background commits (kungfu_tpu/elastic/snapshot.py's
    ``AsyncCommitter``).

    ``initiate(tree, publish)`` dispatches the device-to-host copies on
    the calling thread and hands join and publish to the committer
    thread; ``publish(host_tree)`` runs on that thread once the snapshot
    is on the host, and is the only place a commit becomes visible: it
    must install the host state first and the progress record last (one
    assignment of both does), so a reader never sees progress that points
    at a torn snapshot.  A process killed between the join and the
    publish leaves the previous published commit as the recovery point.

    At most one commit is in flight: ``initiate`` first waits for the
    previous one, then dispatches into the pinned buffers of the commit
    before the last published one (the published one stands until the
    next publish).  A failed join or publish is kept and raised on the
    initiating thread at the next ``initiate()`` or ``drain()``; the
    previous published commit stands.  ``close()`` refuses new work.
    """

    def __init__(self, name: str = "kfsnap-committer"):
        self._cv = threading.Condition()
        self._job = None  # (PendingSnapshot, publish, t0): in flight
        self._error: Optional[BaseException] = None
        self._closed = False
        self._pending: Optional[PendingSnapshot] = None  # the last dispatch
        self._current = None       # host tree of the last published commit
        self._spare = None         # host tree free for the next dispatch
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    # ---------------------------------------------------------- public
    def initiate(self, tree, publish: Callable[[object], None]) -> float:
        """Dispatch a snapshot of ``tree`` and queue its join and
        ``publish``.  Blocks only while the previous commit has not
        finished.  Returns the dispatch's seconds (what the caller's step
        paid)."""
        with self._cv:
            self._raise_pending_locked()
            while self._job is not None and not self._closed:
                self._cv.wait()
            if self._closed:
                raise RuntimeError("AsyncCommitter is closed")
            into, self._spare = self._spare, None
        ps = dispatch(tree, into)
        with self._cv:
            self._pending = ps
            self._job = (ps, publish, time.perf_counter())
            self._cv.notify_all()
        return ps.dispatch_s

    def fence(self) -> None:
        """:meth:`PendingSnapshot.fence` of the last dispatch: call before
        writing in place to state a commit may still be copying."""
        ps = self._pending
        if ps is not None:
            ps.fence()

    def drain(self) -> None:
        """Block until every initiated commit has published (or failed).
        Re-raises the first pipeline error and clears it: the previous
        published commit stands, as if that commit had never been
        initiated."""
        with self._cv:
            while self._job is not None and self._error is None:
                self._cv.wait()
            self._raise_pending_locked()

    @property
    def last(self) -> Optional[PendingSnapshot]:
        """The last dispatched snapshot (its ``dispatch_s``, ``join_s``,
        ``nbytes``)."""
        return self._pending

    def close(self, timeout: float = 10.0) -> None:
        """Finish any in-flight commit and stop the committer thread."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    # -------------------------------------------------------- internals
    def _raise_pending_locked(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._job is None and not self._closed:
                    self._cv.wait()
                if self._job is None:
                    return  # closed and drained
                ps, publish, t0 = self._job
            ok = False
            try:
                host = ps.join()
                publish(host)
                ok = True
            # deferred, not swallowed: the error is raised on the
            # initiating thread at the next drain()/initiate()
            except BaseException as e:
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    if ok:
                        self._spare, self._current = self._current, host
                    else:
                        # the failed commit's buffers are free again
                        self._spare = ps._tree
                    self._job = None
                    self._cv.notify_all()
