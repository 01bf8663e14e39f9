"""Checkpoints (counterpart of kungfu_tpu/checkpoint.py).

The flat ``.npz`` dump: :func:`save_npz` writes a tree with one entry per
leaf, keyed by its key path, dictionary keys and list indices joined by
``/`` (``"layers/0/wq"``, ``"lm_head"``), as
``kungfu_tpu.checkpoint.save_npz`` keys it; :func:`load_npz` and
:func:`restore_npz_like` read either package's dump, so ``python -m
kungfu_tpu_torch.serving --npz`` serves weights the JAX side trained.

Periodic checkpoints: :class:`Checkpointer` keeps a window of steps, one
directory each, holding the state and a ``meta.json``, in one of two
formats (the JAX package writes both through orbax):

- replicated: a tree of plain tensors (``torch.save``), written by rank
  0 of a live group alone on a background thread.  A replica is the
  model, so it restores at any cluster size.
- sharded: a tree with :func:`sharded` leaves (DTensors, ``Shard`` on
  one dimension), written through ``torch.distributed.checkpoint``:
  every rank of the group writes its own blocks, so no rank holds the
  whole state.  ``restore(like=...)`` re-lays the blocks onto the
  template's group, of any size (a template of plain tensors takes the
  whole of each at a world of one).  The global shape is the unpadded
  one, so a flat vector padded to the group size restores at any other.
  This save is collective and synchronous.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .utils.tree import tree_leaves, tree_map


def sharded(local: torch.Tensor, size: int, group=None, dim: int = 0):
    """Rank r's block of a tensor cut along ``dim`` into one padded chunk
    a rank (``local``: chunk r, ``c`` long, the padding at the end of the
    last), as the leaf the Checkpointer saves sharded: a DTensor of
    global length ``size`` along ``dim``, the padding dropped, with
    ``Shard(dim)`` over ``group`` (None: the default group).  Torch's
    ``Shard`` gives rank r the same ceil(size / n) rows.  Without a live
    group it is the plain tensor (a world of one)."""
    c = local.shape[dim]
    if not dist.is_initialized():
        return local.narrow(dim, 0, size)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if c != -(-size // n):
        raise ValueError(f"a chunk of {c} is not the ceil({size} / {n}) "
                         f"a rank holds")
    valid = max(0, min(c, size - r * c))
    shape = list(local.shape)
    shape[dim] = size
    stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    mesh = DeviceMesh.from_group(group or dist.group.WORLD,
                                 local.device.type)
    return DTensor.from_local(local.narrow(dim, 0, valid).contiguous(), mesh,
                              [Shard(dim)], shape=tuple(shape),
                              stride=tuple(stride), run_check=False)


def local_block(t: torch.Tensor, c: int, dim: int = 0) -> torch.Tensor:
    """The padded chunk (``c`` long along ``dim``) of a restored
    :func:`sharded` leaf: its local block with zeros after it."""
    if hasattr(t, "to_local"):
        t = t.to_local()
    else:                                   # a world of one: the whole
        c = max(c, t.shape[dim])
    pad = list(t.shape)
    pad[dim] = c - t.shape[dim]
    return torch.cat([t, t.new_zeros(pad)], dim=dim)


def _is_sharded(tree) -> bool:
    return any(hasattr(t, "device_mesh") for t in tree_leaves(tree))


def _group_of(tree):
    for t in tree_leaves(tree):
        if hasattr(t, "device_mesh"):
            return t.device_mesh.get_group()
    return None


def save_npz(path: str, tree) -> None:
    """Flat ``.npz`` dump of a tree (keys as the module docstring says).
    A bfloat16 tensor is stored as float32, which numpy can hold."""
    flat = {}
    for key, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            leaf = leaf.numpy()
        flat[key] = np.asarray(leaf)
    np.savez(path, **flat)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(template, values: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return values[prefix[:-1]]


def restore_npz_like(template, flat: Union[str, Dict[str, np.ndarray]]):
    """Rebuild a tree of tensors shaped like ``template`` from
    :func:`load_npz`'s dict (or a path): each leaf is looked up by its
    key path, shape-checked, and converted to the template leaf's dtype
    and device."""
    if isinstance(flat, str):
        flat = load_npz(flat)
    values = {}
    for key, leaf in _leaves_with_path(template):
        if key not in flat:
            raise KeyError(f"checkpoint is missing {key!r}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key!r}: checkpoint shape {arr.shape} != "
                             f"model shape {tuple(leaf.shape)}")
        values[key] = torch.tensor(arr, device=leaf.device,
                                   dtype=leaf.dtype)
    return _rebuild(template, values)


class Checkpointer:
    """A window of the ``max_to_keep`` newest checkpoints under
    ``directory``, one subdirectory per step.

    ``save`` snapshots the state to the host on the caller's thread (the
    values as they are at the call) and writes on a background thread;
    ``wait`` blocks until the write has landed.  On a live group only rank
    0 writes; the other ranks' ``save`` returns False."""

    STATE, META, SHARDED = "state.pt", "meta.json", ".metadata"

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state, meta: Optional[Dict[str, Any]] = None,
             force: bool = False) -> bool:
        """Write ``state`` (a tree of tensors and plain values) and
        ``meta`` (JSON) as ``step``.  Returns False when this process does
        not write: not rank 0, or ``step`` exists and not ``force``.

        A ``state`` with :func:`sharded` leaves is written in the sharded
        format: a collective of their group, in which every rank writes
        its blocks; True on every rank once it has landed."""
        from .elastic.snapshot import snapshot
        if _is_sharded(state):
            return self._save_sharded(step, state, meta, force)
        if dist.is_initialized() and dist.get_rank() != 0:
            return False
        self.wait()
        if os.path.exists(self._path(step)) and not force:
            return False
        host = snapshot(state)

        def write():
            try:
                tmp = self._path(step) + ".tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                torch.save(host, os.path.join(tmp, self.STATE))
                with open(os.path.join(tmp, self.META), "w") as f:
                    json.dump(meta, f)
                shutil.rmtree(self._path(step), ignore_errors=True)
                os.replace(tmp, self._path(step))
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._path(old), ignore_errors=True)
            except BaseException as e:          # re-raised by wait()
                self._error = e

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()
        return True

    def _save_sharded(self, step, state, meta, force) -> bool:
        import torch.distributed.checkpoint as dcp
        group = _group_of(state)
        self.wait()
        if os.path.exists(self._path(step)) and not force:
            return False
        tmp = self._path(step) + ".tmp"
        lead = dist.get_rank(group) == 0
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        dist.barrier(group)
        dcp.save(dict(_leaves_with_path(state)),
                 storage_writer=dcp.FileSystemWriter(tmp),
                 process_group=group)
        if lead:
            with open(os.path.join(tmp, self.META), "w") as f:
                json.dump(meta, f)
            shutil.rmtree(self._path(step), ignore_errors=True)
            os.replace(tmp, self._path(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)
        dist.barrier(group)
        return True

    def saved_keys(self, step: Optional[int] = None
                   ) -> Dict[str, Optional[Tuple[Tuple[int, ...],
                                                 torch.dtype]]]:
        """A sharded checkpoint's leaves: key path -> (global shape,
        dtype), or None for a value that is not a tensor."""
        import torch.distributed.checkpoint as dcp
        step = self._step(step)
        md = dcp.FileSystemReader(self._path(step)).read_metadata()
        out = {}
        for key, m in md.state_dict_metadata.items():
            size = getattr(m, "size", None)
            out[key] = None if size is None else (tuple(size),
                                                  m.properties.dtype)
        return out

    def wait(self) -> None:
        """Block until the last save has landed; raise its error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self._path(int(d)), self.META)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like=None, step: Optional[int] = None
                ) -> Tuple[int, Any, Optional[Dict[str, Any]]]:
        """``(step, state, meta)`` of ``step`` (default: the latest).  The
        state's tensors are on the CPU; with ``like`` (a tree of the same
        structure) each is converted to the dtype and device of the
        matching leaf of ``like``, its shape checked.

        A sharded checkpoint needs ``like`` and loads into its tensors in
        place: :func:`sharded` leaves over the group to restore onto (a
        collective of it), or plain tensors of the global shapes."""
        step = self._step(step)
        path = self._path(step)
        with open(os.path.join(path, self.META)) as f:
            meta = json.load(f)
        if os.path.exists(os.path.join(path, self.SHARDED)):
            return step, self._restore_sharded(path, like), meta
        state = torch.load(os.path.join(path, self.STATE))
        if like is not None:
            state = _like(state, like)
        return step, state, meta

    def _step(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return step

    @staticmethod
    def _restore_sharded(path: str, like):
        import torch.distributed.checkpoint as dcp
        if like is None:
            raise ValueError("a sharded checkpoint restores into a "
                             "template: give like=")
        flat = dict(_leaves_with_path(like))
        dcp.load(flat, checkpoint_id=path, process_group=_group_of(like),
                 no_dist=not dist.is_initialized())
        return _rebuild(like, flat)

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _like(state, like):
    """``state`` with each tensor converted to the dtype and device of the
    matching leaf of ``like`` (same structure), its shape checked."""
    keys = iter([k for k, _ in _leaves_with_path(like)])

    def conv(t, leaf):
        key = next(keys)
        if not isinstance(leaf, torch.Tensor):
            return t
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key!r}: checkpoint shape {tuple(t.shape)} "
                             f"!= model shape {tuple(leaf.shape)}")
        return t.to(dtype=leaf.dtype, device=leaf.device)
    return tree_map(conv, state, like)
