"""Host-to-device input pipeline: background staging with device prefetch
(counterpart of kungfu_tpu/data/pipeline.py).

While the step computes on batch *i*, a worker thread pulls batch *i+1*
from the source (decode, augment, shard: whatever the source does) and
stages it on the card, keeping ``depth`` staged batches ready, so the
step never waits on host conversion and the copy after the previous
step.

- :class:`Prefetcher` wraps any iterator of (trees of) numpy arrays or
  CPU tensors; ``place`` maps a host batch to its staged form.
  Exceptions from the source surface at the consuming ``next()``; the
  end of the stream is latched; ``close()`` stops and joins the worker.
- :func:`to_device` is the default ``place``.  On the card it copies each
  leaf into pinned host memory and issues a ``non_blocking`` copy to the
  card on a side ``torch.cuda.Stream``, with one event per batch: the
  consuming stream waits on that event before it reads the batch, and
  each staged tensor is marked as used by the consuming stream
  (``record_stream``) so the allocator does not hand its memory to the
  side stream while the step still reads it.  The worker waits for the
  copy before it lets go of the pinned buffer, so a pinned buffer is
  never reused while its copy is in flight.  On the CPU it converts.
- :func:`prefetch_to_mesh` stages what one rank consumes: its
  contiguous block of each global batch, sliced on the host before the
  copy.  Such a batch goes to the train step as ``step(batch,
  local=True)``; the steps otherwise take the global batch and slice
  the rank's block themselves.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.tree import tree_leaves, tree_map

__all__ = ["Prefetcher", "to_device", "prefetch_to_mesh"]

_SENTINEL = object()


class _Staged:
    """A batch on the card whose copy is tracked by ``event``."""

    def __init__(self, tree, event):
        self.tree, self.event = tree, event


def _pinned(x) -> torch.Tensor:
    """A copy of host array ``x`` in pinned (page-locked) memory."""
    src = torch.as_tensor(x)
    return torch.empty(src.shape, dtype=src.dtype,
                       pin_memory=True).copy_(src)


def to_device(device=None) -> Callable:
    """The ``place`` that stages a host batch on ``device`` (``None``:
    the card, raising when there is none)."""
    device = resolve_device(device)
    if device.type == "cpu":
        return lambda batch: tree_map(torch.as_tensor, batch)
    stream = torch.cuda.Stream(device)

    def place(batch):
        host = tree_map(_pinned, batch)
        with torch.cuda.stream(stream):
            staged = tree_map(lambda h: h.to(device, non_blocking=True),
                              host)
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()         # the pinned buffers may go after this
        return _Staged(staged, event)

    return place


class Prefetcher:
    """Iterator adaptor: stages ``depth`` batches ahead.

    ``place`` maps a host batch (a tree of numpy arrays or CPU tensors)
    to its staged form; the default, ``to_device()``, stages on the card
    and raises without one.  The worker thread runs the SOURCE and the
    placement, so per-batch host work overlaps the previous step.
    """

    def __init__(self, source: Iterator, depth: int = 2,
                 place: Optional[Callable] = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._place = place or to_device()
        self._src = source
        self._err: Optional[BaseException] = None
        self._done = False          # latched: stream ended or closed
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for batch in self._src:
                if self._stop.is_set():
                    return
                staged = self._place(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:        # surfaced at the consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        # latched end state: a second loop / a retry after the surfaced
        # source error / a next() after close() must not block forever
        # on the consumed one-shot sentinel
        if self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        if isinstance(item, _Staged):
            leaves = tree_leaves(item.tree)
            consumer = torch.cuda.current_stream(leaves[0].device)
            consumer.wait_event(item.event)
            for t in leaves:
                t.record_stream(consumer)
            return item.tree
        return item

    def close(self):
        """Stop the worker (used on early exit; idempotent)."""
        self._done = True
        self._stop.set()
        # drain so a blocked put wakes up
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch_to_mesh(source: Iterator, group=None, depth: int = 2,
                     device=None) -> Prefetcher:
    """Prefetch the rank's contiguous block of each global batch of
    ``source`` (the block ``build_train_step`` takes along axis 0) onto
    ``device``: only that block is copied.  Feed the result to the step
    as ``step(batch, local=True)``.  ``group``: the peer group (None =
    the default group)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    place = to_device(device)

    def block(x):
        if np.shape(x)[0] % world:
            raise ValueError(f"global batch {np.shape(x)[0]} not divisible "
                             f"by {world} ranks")
        n = np.shape(x)[0] // world
        return x[rank * n:(rank + 1) * n]

    return Prefetcher(source, depth=depth,
                      place=lambda batch: place(tree_map(block, batch)))
