"""FSDP/ZeRO-style sharded data parallelism (counterpart of
kungfu_tpu/parallel/fsdp.py).

Parameters, gradients and optimizer state live sharded over a process
group as one flat vector: the tree is ravelled in JAX's leaf order
(``utils.tree``: dictionary keys sorted, as ``ravel_pytree`` takes them),
padded with zeros to a multiple of the group size n, and rank r keeps the
contiguous chunk r.  Each step all-gathers the parameters, takes the
gradient, mean-reduce-scatters it and updates only the local chunk:
ZeRO-3 as three collectives (``comm.collectives``).

- :func:`make_fsdp_step`: ZeRO-3 over the whole flat vector.
- :func:`make_fsdp_scan_step`: ZeRO-3 one layer at a time, the memory
  profile ZeRO-3 exists for.
- :func:`make_zero1_step`: replicated parameters, sharded optimizer
  state.

Each keeps JAX's ``init, make_step`` pair, with these differences that
torch forces (ROADMAP Queue 3):

- ``optimizer`` is a factory, ``optimizer(params) -> torch.optim``
  optimizer, built by ``init`` over this rank's shard tensors; its state
  mirrors the shard (Adam's moments are 1/n a rank) and its scalar
  bookkeeping (Adam's ``step``) is the same on every rank.  The state is
  made at the first step, as torch makes it, not at ``init``.
- ``step(shards, opt, batch) -> loss`` updates the shards and the
  optimizer in place and returns the mean loss over the group.
- ``batch`` is the GLOBAL batch, the same on every rank: each rank takes
  its contiguous block of rows (the batch dimension must divide by n).
- ``group`` is the process group of the fsdp axis (None: the default
  group) where JAX takes a mesh and an axis name.

The optimizer must be elementwise (SGD, momentum, Adam, AdamW, ...) for
the trajectory to match the replicated one; the padding then stays zero,
AdamW's decay included.  ``shard_pytree_spec`` (a ``NamedSharding``) has
no counterpart: a rank's chunk is a plain tensor.

:data:`gathered` counts the parameter bytes that the ZeRO-3 gathers hold
alive: each gathered copy adds its bytes when it is made and gives them
back when it is freed (``weakref.finalize``).
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from ..comm import collectives as C
from ..utils.tree import tree_leaves, tree_map

FSDP_AXIS = "fsdp"

# bytes of gathered parameter copies: alive now, the most alive at once
# since the last reset_gathered(), and the gathers made
gathered = {"live": 0, "peak": 0, "calls": 0}


def reset_gathered() -> None:
    gathered["peak"] = gathered["live"]
    gathered["calls"] = 0


def _release(nbytes: int) -> None:
    gathered["live"] -= nbytes


def _counted(t: torch.Tensor) -> torch.Tensor:
    nbytes = t.numel() * t.element_size()
    gathered["live"] += nbytes
    gathered["peak"] = max(gathered["peak"], gathered["live"])
    gathered["calls"] += 1
    weakref.finalize(t, _release, nbytes)
    return t


def _pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    return torch.cat([x, x.new_zeros(pad)]) if pad else x


def fsdp_grad_sync(flat_grads: torch.Tensor, group=None) -> torch.Tensor:
    """Mean-reduce-scatter of a flat gradient vector (ZeRO grad sync)."""
    n = dist.get_world_size(group)
    return C._reduce_scatter_tiled(flat_grads, group) / n


def fsdp_all_gather_params(param_shard: torch.Tensor, group=None
                           ) -> torch.Tensor:
    """Reassemble the full flat parameter vector from shards (its
    gradient is the summing reduce-scatter)."""
    return C.gather_from_group(param_shard, group)


def _unraveller(tree) -> Tuple[int, Callable]:
    """The length of ``tree``'s flat vector and ``unravel(flat)``, which
    gives the tree back as views of ``flat`` (padding past the end
    ignored).  Its gradient reaches ``flat`` through one split, padding
    included, so the backward writes one buffer.  Only the structure is
    read (leaves on the ``meta`` device will do), and ``unravel`` closes
    over it alone, so the input tree dies with its last outside
    reference."""
    leaves = tree_leaves(tree)
    shapes = [tuple(t.shape) for t in leaves]
    sizes = [t.numel() for t in leaves]
    size = sum(sizes)
    skeleton = tree_map(lambda _: None, tree)

    def unravel(f):
        parts = torch.split(f, sizes + [f.shape[0] - size])
        views = iter(p.view(s) for p, s in zip(parts, shapes))
        return tree_map(lambda _: next(views), skeleton)
    return size, unravel


def _chunk(flat: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Rank r's contiguous chunk of a vector padded to a multiple of n,
    as a new f32 leaf that takes a gradient."""
    local = flat.shape[-1] // n
    return flat[..., r * local:(r + 1) * local].clone().requires_grad_()


def _local_rows(batch, group):
    """This rank's contiguous block of rows of every tensor in
    ``batch`` (JAX's batch sharded over the axis)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)

    def rows(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} rows does not split "
                             f"over {n} ranks")
        return t.chunk(n)[r]
    return tree_map(rows, batch)


def _mean_loss(loss: torch.Tensor, group) -> torch.Tensor:
    return C.all_reduce(loss.detach().float(), group, "MEAN")


def _state_specs(optimizer: torch.optim.Optimizer, shards
                 ) -> Dict[str, Dict[str, str]]:
    """For each shard (``shards``: name -> tensor) and each entry of the
    optimizer's state for it: "shard" where the entry mirrors the shard
    (Adam's moments), "replicated" for scalar bookkeeping (Adam's
    step)."""
    out = {}
    for name, p in shards.items():
        out[name] = {k: ("shard" if isinstance(v, torch.Tensor)
                         and v.shape == p.shape else "replicated")
                     for k, v in optimizer.state.get(p, {}).items()}
    return out


class FlatMeta(NamedTuple):
    """What ``init`` learned of the tree: ``unravel`` of the padded flat
    vector, the unpadded ``size``, the chunk a rank holds (``local``),
    the group and its size ``n`` and this rank ``r``."""
    unravel: Callable
    size: int
    local: int
    group: object
    n: int
    r: int


def flat_meta(tree, group=None) -> FlatMeta:
    """The :class:`FlatMeta` of ``tree`` over ``group`` from its structure
    alone: no flat vector is made, so a rank that will adopt its chunk
    from elsewhere (an elastic re-shard) never holds the whole vector."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size, unravel = _unraveller(tree)
    return FlatMeta(unravel, size, -(-size // n), group, n, r)


def _flat_init(params, group) -> Tuple[torch.Tensor, FlatMeta]:
    """Shared ZeRO init: ravel ``params`` (``ravel_pytree``: the leaves
    concatenated in tree order, as f32), pad to the group size; returns
    the padded flat vector and its meta."""
    meta = flat_meta(params, group)
    flat = torch.cat([t.detach().reshape(-1).float()
                      for t in tree_leaves(params)])
    return _pad_to(flat, meta.n), meta


def make_fsdp_step(loss_fn: Callable, optimizer: Callable, group=None
                   ) -> Tuple[Callable, Callable]:
    """Build ``(init, make_step)`` for fully-sharded training::

        init, make_step = make_fsdp_step(loss_fn, make_opt, group)
        shard, opt, meta = init(params)
        step = make_step(meta)
        loss = step(shard, opt, batch)      # shard, opt updated in place

    ``loss_fn(params, batch) -> scalar`` on this rank's rows; ``shard``
    is this rank's f32 chunk of the padded flat vector.  Each step
    gathers the whole vector, so peak memory holds the full parameters:
    :func:`make_fsdp_scan_step` gathers a layer at a time."""
    def init(params):
        flat, meta = _flat_init(params, group)
        shard = _chunk(flat, meta.n, meta.r)
        return shard, optimizer([shard]), meta

    def make_step(meta: FlatMeta):
        def step(shard, opt, batch):
            with torch.no_grad():
                full = _counted(fsdp_all_gather_params(shard, meta.group))
            full.requires_grad_(True)
            loss = loss_fn(meta.unravel(full),
                           _local_rows(batch, meta.group))
            (gflat,) = torch.autograd.grad(loss, [full])
            del full
            shard.grad = fsdp_grad_sync(gflat, meta.group)
            del gflat
            opt.step()
            shard.grad = None
            return _mean_loss(loss, meta.group)
        return step

    return init, make_step


class ScanMeta(NamedTuple):
    """The three flat pieces of :func:`make_fsdp_scan_step`'s model, by
    name ("embed", "layers": one layer's, "head"), each a
    :class:`FlatMeta`, and the number of layers."""
    pieces: Dict[str, FlatMeta]
    n_layers: int


def _mean(grads, n: int):
    """The gathers' adjoint summed each gradient over the ranks: divide
    for the mean."""
    return [g / n for g in grads]


def make_fsdp_scan_step(embed_fn: Callable, layer_fn: Callable,
                        head_loss_fn: Callable, optimizer: Callable,
                        group=None, remat: bool = True
                        ) -> Tuple[Callable, Callable]:
    """ZeRO-3 with its real memory profile: one layer gathered at a time.

    The embedding and head are gathered once a step; each layer is
    gathered inside its iteration of a loop over the stacked layers, so
    the gathered copy dies when the iteration ends, and with ``remat``
    (the default) the gather and the layer sit in one
    ``torch.utils.checkpoint``, so the backward gathers the layer again
    instead of keeping its residuals.  Peak ~ the shards + one layer's
    parameters + activations.  The gather's adjoint is a reduce-scatter
    (``collectives.gather_from_group``), so the gradients arrive sharded
    with no further sync.

    Model contract (embed -> L x layer -> head)::

        embed_fn(embed_params, batch)            -> activations
        layer_fn(layer_params, activations)      -> activations
        head_loss_fn(head_params, activations, batch) -> scalar loss

    ``init(params)`` takes ``{"embed": tree, "layers": stacked tree
    (leading axis L on every leaf), "head": tree}`` and returns ``(shards,
    opt, meta)``: ``shards`` is ``{"embed": [e], "layers": [L, l],
    "head": [h]}``, this rank's chunks, and ``opt`` is built over them in
    tree order (embed, head, layers)."""
    def init(params):
        layers = params["layers"]
        L = tree_leaves(layers)[0].shape[0]
        pieces, flats = {}, {}
        for name in ("embed", "head"):
            flats[name], pieces[name] = _flat_init(params[name], group)
        rows = []
        for i in range(L):
            row, pieces["layers"] = _flat_init(
                tree_map(lambda t: t[i], layers), group)
            rows.append(row)
        flats["layers"] = torch.stack(rows)
        meta = pieces["layers"]
        shards = {k: _chunk(f, meta.n, meta.r) for k, f in flats.items()}
        return shards, optimizer(tree_leaves(shards)), ScanMeta(pieces, L)

    def make_step(meta: ScanMeta):
        P = meta.pieces
        group, n = P["layers"].group, P["layers"].n

        def gather(name, shard):
            return P[name].unravel(_counted(
                fsdp_all_gather_params(shard, group)))

        def layer_step(layer_shard, act):
            return layer_fn(gather("layers", layer_shard), act)

        if remat:
            def layer_step(layer_shard, act, _f=layer_step):
                return torch.utils.checkpoint.checkpoint(
                    _f, layer_shard, act, use_reentrant=False)

        def embed(shards, batch):
            return embed_fn(gather("embed", shards["embed"]), batch)

        def step(shards, opt, batch):
            batch = _local_rows(batch, group)
            head = gather("head", shards["head"])
            act = embed(shards, batch)
            for layer_shard in shards["layers"].unbind(0):
                act = layer_step(layer_shard, act)
            loss = head_loss_fn(head, act, batch)
            del head, act
            leaves = tree_leaves(shards)
            grads = torch.autograd.grad(loss, leaves)
            for p, g in zip(leaves, _mean(grads, n)):
                p.grad = g
            del grads
            opt.step()
            for p in leaves:
                p.grad = None
            return _mean_loss(loss, group)
        return step

    return init, make_step


class Zero1Meta(NamedTuple):
    """:class:`FlatMeta` of the tree and the optimizer's parameter, this
    rank's chunk (refreshed from the replica at every step)."""
    flat: FlatMeta
    shard: torch.Tensor


def _zero1_apply(flat, shard, before, group) -> None:
    """Add every rank's chunk of updates (the optimizer's new chunk less
    the one it started from) to the replicated vector: JAX's
    ``flat_params + all_gather(updates)``, which rounds as JAX does."""
    flat += C._gather_tiled(shard.detach() - before, group)


def make_zero1_step(loss_fn: Callable, optimizer: Callable, group=None
                    ) -> Tuple[Callable, Callable]:
    """ZeRO-1: replicated parameters, sharded optimizer state::

        init, make_step = make_zero1_step(loss_fn, make_opt, group)
        flat, opt, meta = init(params)
        step = make_step(meta)
        loss = step(flat, opt, batch)       # flat, opt updated in place

    Each rank takes the gradient of its rows, mean-reduce-scatters the
    flat gradient to its chunk, runs the optimizer on that chunk only
    (Adam's moments cost 1/n) and all-gathers the chunk's updates into
    every replica.  For elementwise optimizers the trajectory is the
    replicated one."""
    def init(params):
        flat, meta = _flat_init(params, group)
        shard = _chunk(flat, meta.n, meta.r)
        return flat, optimizer([shard]), Zero1Meta(meta, shard)

    def make_step(meta: Zero1Meta):
        m, shard = meta.flat, meta.shard
        lo = m.r * m.local

        def step(flat, opt, batch):
            full = flat.detach().requires_grad_(True)
            loss = loss_fn(m.unravel(full), _local_rows(batch, m.group))
            (gflat,) = torch.autograd.grad(loss, [full])
            del full
            gshard = fsdp_grad_sync(gflat, m.group)
            del gflat
            with torch.no_grad():
                shard.copy_(flat[lo:lo + m.local])
                before = shard.detach().clone()
            shard.grad = gshard
            opt.step()
            shard.grad = None
            with torch.no_grad():
                _zero1_apply(flat, shard, before, m.group)
            return _mean_loss(loss, m.group)
        return step

    return init, make_step


def _pieces(shards, meta):
    """name -> (this rank's chunk of the parameters, its FlatMeta, the
    optimizer's parameter that keys its state) for any of the three
    steps' state."""
    if isinstance(meta, ScanMeta):
        return {k: (shards[k], meta.pieces[k], shards[k]) for k in shards}
    if isinstance(meta, Zero1Meta):
        m = meta.flat
        return {"flat": (shards[m.r * m.local:(m.r + 1) * m.local], m,
                         meta.shard)}
    return {"flat": (shards, meta, shards)}


def fsdp_state_dict(shards, opt: torch.optim.Optimizer, meta) -> Dict:
    """The state of any of the three steps as a tree for
    ``checkpoint.Checkpointer.save``: ``{"params": {name: chunk}, "opt":
    {name: {entry: value}}}``, where every parameter chunk and every
    optimizer entry that mirrors one is a ``checkpoint.sharded`` leaf
    (the unpadded global vector, each rank writing its block) and the
    scalar entries (Adam's step) are saved as they are."""
    from ..checkpoint import sharded
    out = {"params": {}, "opt": {}}
    pieces = _pieces(shards, meta)
    specs = _state_specs(opt, {k: p for k, (_, _, p) in pieces.items()})
    for name, (vals, m, p) in pieces.items():
        dim = vals.dim() - 1
        out["params"][name] = sharded(vals.detach(), m.size, m.group, dim)
        out["opt"][name] = {
            k: sharded(v, m.size, m.group, dim)
            if specs[name][k] == "shard" else v
            for k, v in opt.state.get(p, {}).items()}
    return out


def load_fsdp_state_dict(ckpt, shards, opt: torch.optim.Optimizer, meta,
                         step=None):
    """Restore a :func:`fsdp_state_dict` checkpoint, written at any group
    size, into this layout: the shards and the optimizer's state (made
    here, for an optimizer that has not stepped yet).  A ZeRO-1 replica
    reads the whole vector.  Returns ``(step, meta_json)``."""
    from ..checkpoint import local_block, sharded
    pieces = _pieces(shards, meta)
    saved = ckpt.saved_keys(step)
    like = {"params": {}, "opt": {}}
    for name, (vals, m, p) in pieces.items():
        dim = vals.dim() - 1
        if isinstance(meta, Zero1Meta):
            like["params"][name] = torch.zeros(m.size, device=vals.device)
        else:
            like["params"][name] = sharded(torch.zeros_like(vals), m.size,
                                           m.group, dim)
        like["opt"][name] = {}
        for key, info in saved.items():
            if not key.startswith(f"opt/{name}/"):
                continue
            shape, dtype = info
            entry = key.split("/", 2)[2]
            if shape == (*vals.shape[:-1], m.size):
                like["opt"][name][entry] = sharded(
                    torch.zeros_like(p, dtype=dtype), m.size, m.group, dim)
            else:
                like["opt"][name][entry] = torch.zeros(shape, dtype=dtype)
    step, state, meta_json = ckpt.restore(like, step)
    with torch.no_grad():
        for name, (vals, m, p) in pieces.items():
            dim = vals.dim() - 1
            got = state["params"][name]
            if isinstance(meta, Zero1Meta):
                shards[:m.size].copy_(got)
                shards[m.size:].zero_()
                p.copy_(vals)
            else:
                vals.copy_(local_block(got, m.local, dim))
            opt.state[p] = {
                k: local_block(v, m.local, dim)
                if v.shape[-1:] == (m.size,) and v.dim() == p.dim() else v
                for k, v in state["opt"][name].items()}
    return step, meta_json
