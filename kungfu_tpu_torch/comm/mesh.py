"""Mesh axes as ``torch.distributed`` process groups (counterpart of
kungfu_tpu/comm/mesh.py).

Where the JAX package names a mesh axis, the port passes the process
group of that axis: NCCL on the card, gloo on the CPU.  The flat peer
axis is :func:`flat_mesh`; an N-D mesh such as (dp, sp, tp) is a
:class:`ProcessMesh` (:func:`make_mesh`), which holds this rank's
coordinates and one group per axis and per combination of axes that a
caller asks for; :func:`serving_mesh` adds a gloo **control group** over
the mesh's ranks for host messages (tensor-parallel serving's
commands).  Nothing here discovers a cluster; the caller
gives the rendezvous, its rank and the world size
(:func:`init_process_group_file`).
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.tree import tree_map

PEER_AXIS = "kf_peers"      # flat data-parallel axis
TP_AXIS = "tp"

# the control group's collective timeout: a follower waits for its next
# command as long as the server idles (a dead peer still fails the wait
# at once: gloo closes its sockets)
CONTROL_TIMEOUT = datetime.timedelta(days=3650)


def init_process_group_file(path: str, rank: int, world: int,
                            backend: Optional[str] = None,
                            timeout_s: Optional[float] = None) -> None:
    """Join the default group through a ``FileStore`` at ``path`` (a file
    every rank can reach; no TCP port is taken).  ``backend`` defaults to
    NCCL where CUDA is available, else gloo.  ``timeout_s``: a collective
    of the group raises after that many seconds (None: torch's
    default)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    # torch.distributed.nn holds group.WORLD as a default argument once
    # imported; import it before the group forms (distributed.initialize)
    importlib.import_module("torch.distributed.nn")
    store = dist.FileStore(path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=_timeout(timeout_s))


def _timeout(seconds: Optional[float]):
    return None if seconds is None else datetime.timedelta(seconds=seconds)


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


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in an N-D mesh of ranks: the axis names and
    sizes, its coordinates, and the process group of each axis and each
    combination of axes that :func:`make_mesh` formed (keyed by the tuple
    of axis names in mesh order; a single axis also by its name), and
    ``control``: a gloo group over all the mesh's ranks for CPU tensors
    with no practical timeout (:func:`serving_mesh`'s; else None)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], object]
    control: object = None

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[self.axis_names.index(a)] for a in axes)

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, *axes: str):
        """The group of ``axes`` (in any order) that holds this rank."""
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(axes):
            raise ValueError(f"axes {axes} not all in {self.axis_names}")
        if key not in self.groups:
            raise KeyError(f"no group formed for axes {key}; pass them to "
                           f"make_mesh(groups=...)")
        return self.groups[key]


def make_mesh(axis_names: Sequence[str], shape: Sequence[int],
              groups: Optional[Sequence[Sequence[str]]] = None,
              timeout_s: Optional[float] = None) -> Optional[ProcessMesh]:
    """An N-D mesh over the first ``prod(shape)`` ranks of the default
    group, the last axis innermost: rank = ((c0 * s1 + c1) * s2 + c2)...,
    JAX's device order.  Forms one process group for each axis and for
    each combination in ``groups`` (tuples of axis names; default: each
    axis alone).  Every rank of the default group must call it with the
    same arguments, since ``new_group`` is collective; a rank past the
    mesh takes part in forming the groups and gets None.  The groups take
    the default group's backend; ``timeout_s``: a collective of a group
    raises after that long (None: torch's default)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group_file "
                           "(or torch.distributed.init_process_group) first")
    names, shape = tuple(axis_names), tuple(int(s) for s in shape)
    if len(names) != len(shape) or len(set(names)) != len(names):
        raise ValueError(f"axis names {names} do not match shape {shape}")
    n, world = math.prod(shape), dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks for mesh {shape}, have {world}")
    combos = [(a,) for a in names] if groups is None else [
        tuple(a for a in names if a in c) for c in groups]
    for c in combos:
        if not c or not set(c) <= set(names):
            raise ValueError(f"group axes {c} not in {names}")
    me = dist.get_rank()
    coords = (tuple(int(i) for i in _unravel(me, shape)) if me < n
              else None)
    formed = {}
    for combo in dict.fromkeys(combos):
        axes = [names.index(a) for a in combo]
        rest = [i for i in range(len(names)) if i not in axes]
        for fixed in itertools.product(*(range(shape[i]) for i in rest)):
            ranks = []
            for free in itertools.product(*(range(shape[i]) for i in axes)):
                c = [0] * len(names)
                for i, v in zip(rest, fixed):
                    c[i] = v
                for i, v in zip(axes, free):
                    c[i] = v
                ranks.append(_ravel(c, shape))
            g = dist.new_group(ranks, timeout=_timeout(timeout_s))
            if me in ranks:
                formed[combo] = g
    if coords is None:
        return None
    return ProcessMesh(names, shape, coords, formed)


def shard_tree(tree, specs, mesh: Optional[ProcessMesh]):
    """This rank's block of every leaf of a full tree, as new tensors
    (JAX places a full tree by ``NamedSharding``).  ``specs`` has the
    tree's nesting and holds, for each leaf, the mesh axis each leading
    dimension splits over, in order, or None (a ``PartitionSpec`` as a
    tuple; missing trailing entries are None, and a tuple of names splits
    a dimension over those axes jointly, the first major).  ``mesh=None``
    copies the tree whole."""
    def take(x, spec):
        if mesh is not None:
            for dim, axes in enumerate(spec):
                if axes is None:
                    continue
                axes = (axes,) if isinstance(axes, str) else tuple(axes)
                n, i = 1, 0
                for a in axes:
                    n, i = n * mesh.size(a), i * mesh.size(a) + mesh.index(a)
                if x.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of size "
                                     f"{x.shape[dim]} does not split over "
                                     f"{n} ranks of {axes}")
                x = x.chunk(n, dim=dim)[i]
        return x.clone()
    return tree_map(take, tree, specs)


def serving_mesh(n: int, timeout_s: Optional[float] = None
                 ) -> Optional[ProcessMesh]:
    """The tp-only mesh of tensor-parallel serving over the first ``n``
    ranks (``make_mesh(("tp",), (n,))``) with its control group
    (``ProcessMesh.control``: gloo whatever the default group's backend,
    timed out only after ``CONTROL_TIMEOUT``).  The data group
    (``mesh.group("tp")``) carries the programs' all-reduces and the
    vocabulary gather; the control group carries rank 0's commands and
    the token check.  Collective, as :func:`make_mesh`."""
    mesh = make_mesh((TP_AXIS,), (n,), timeout_s=timeout_s)
    ctl = dist.new_group(list(range(n)), backend="gloo",
                         timeout=CONTROL_TIMEOUT)
    return None if mesh is None else dataclasses.replace(mesh, control=ctl)


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def _unravel(rank: int, shape):
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))
