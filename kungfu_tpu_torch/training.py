"""Distributed training: broadcast and the synchronous train step
(counterpart of kungfu_tpu/training.py).

In the JAX package each mesh lane owns a replica stored as a stacked,
sharded pytree, so ``replicate`` and ``init_opt_state`` build those
stacks.  In the port each rank is a process that holds its own replica
(the parameter tree) and its optimizer holds its own state, so neither
has a counterpart: a rank builds its parameters, calls
:func:`broadcast_variables` to align them with the root, and builds its
optimizer on them.  The steps, :func:`build_train_step` and, for models
with state that is not trained (BatchNorm running statistics),
:func:`build_train_step_with_state`, update the rank's tensors in place.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from . import ops
from .comm import collectives as C
from .utils.tree import tree_leaves, tree_map


def broadcast_variables(params, group=None, root: int = 0):
    """Overwrite every rank's tensors of ``params`` in place with rank
    ``root``'s (the reference's BroadcastGlobalVariables).  Returns
    ``params``."""
    src = root if group is None else dist.get_global_rank(group, root)
    with torch.no_grad():
        for t in tree_leaves(params):
            dist.broadcast(t, src=src, group=group)
    return params


def lane_mean(params, group=None):
    """The mean of the replicas over the group, as new tensors (useful
    after model-averaging training)."""
    return C.all_reduce(params, group, "MEAN")


def _cast_params(params, dtype):
    """Float leaves -> ``dtype`` copies (non-float leaves untouched)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    params)


def _local_slice(batch, rank: int, world: int):
    """This rank's contiguous block of the global batch along axis 0."""
    def take(t):
        if t.shape[0] % world:
            raise ValueError(f"global batch {t.shape[0]} not divisible by "
                             f"{world} ranks")
        n = t.shape[0] // world
        return t[rank * n:(rank + 1) * n]
    return tree_map(take, batch)


def _split(batch, k: int):
    """``k`` equal microbatches along axis 0."""
    for t in tree_leaves(batch):
        if t.shape[0] % k:
            raise ValueError(f"per-rank batch {t.shape[0]} not divisible "
                             f"by accum_steps={k}")
    return [tree_map(lambda t: t[i * (t.shape[0] // k):
                                 (i + 1) * (t.shape[0] // k)], batch)
            for i in range(k)]


def _rank_batch(batch, group, local: bool):
    """The part of ``batch`` this rank consumes: all of it when ``local``
    (already the rank's block), else its block of the global batch."""
    if local:
        return batch
    return _local_slice(batch, dist.get_rank(group),
                        dist.get_world_size(group))


def _accum_grads_fn(loss_fn: Callable, params, accum_steps: int,
                    compute_dtype, has_aux: bool):
    """Microbatch gradient accumulation and mixed precision, shared by the
    two step builders (the JAX package's ``_accum_grads_fn`` and
    ``_mixed_precision``: the casting rules must never diverge between
    them).

    Returns ``(masters, grads_of)``.  ``grads_of(batch, mstate=None) ->
    (mean loss, mstate)`` splits ``batch`` into ``accum_steps``
    microbatches, runs ``loss_fn`` on each (threading the model state
    through them in order when ``has_aux``), accumulates the gradients in
    f32 and leaves their mean, rounded once to the compute dtype, in the
    ``.grad`` of each f32 master (the float leaves of ``params``)."""
    if accum_steps < 1:
        raise ValueError("accum_steps must be >= 1")
    masters = [t for t in tree_leaves(params) if t.is_floating_point()]

    def grads_of(batch, mstate=None):
        micro = _split(batch, accum_steps)
        with torch.no_grad():
            if compute_dtype is None:
                work = tree_map(lambda t: t.detach(), params)
            else:
                work = _cast_params(params, compute_dtype)
        leaves = [t for t in tree_leaves(work) if t.is_floating_point()]
        for t in leaves:
            t.requires_grad_(True)
        acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=masters[0].device)
        for mb in micro:
            if has_aux:
                loss, mstate = loss_fn(work, mstate, mb)
            else:
                loss = loss_fn(work, mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    if g is not None:
                        a += g.float()
                loss_sum += loss.detach().float()
        with torch.no_grad():
            for m, a, w in zip(masters, acc, leaves):
                m.grad = (a / accum_steps).to(w.dtype).to(m.dtype)
        return loss_sum / accum_steps, mstate

    return masters, grads_of


def _update(optimizer, masters) -> None:
    optimizer.step()
    for m in masters:
        m.grad = None


def build_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                     params, group=None, accum_steps: int = 1,
                     compute_dtype=None) -> Callable:
    """The synchronous train step.

    ``loss_fn(params, batch) -> scalar``; ``optimizer`` (usually a
    :func:`~kungfu_tpu_torch.optimizers.synchronous_sgd`) was built on
    the float leaves of ``params``, the f32 master tree.  The returned
    ``step(global_batch, local=False) -> mean loss`` (a 0-d f32 tensor,
    the mean over the group) takes the GLOBAL batch: each rank takes its
    contiguous block along axis 0, as the JAX step shards the batch over
    lanes.  ``local=True`` says the batch is already this rank's block,
    as :func:`~kungfu_tpu_torch.data.pipeline.prefetch_to_mesh` stages
    it.  The step updates ``params`` in place.

    ``accum_steps > 1`` splits the rank's block into that many
    microbatches and accumulates their gradients in f32; the optimizer,
    and so the gradient all-reduce, runs once on the mean, which equals
    one big-batch step.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): mixed precision.  Every
    float leaf (embeddings, norms and the head included) is cast once per
    step; each microbatch's gradients are those of the cast copy,
    accumulated in an f32 buffer, divided by k, rounded to the compute
    dtype once, upcast to f32, and handed to the optimizer, which updates
    the f32 master.  Gradients come from ``torch.autograd.grad`` per
    microbatch, so ``.grad`` never accumulates in the compute dtype.
    """
    masters, grads_of = _accum_grads_fn(loss_fn, params, accum_steps,
                                        compute_dtype, has_aux=False)

    def step(global_batch, local: bool = False):
        loss, _ = grads_of(_rank_batch(global_batch, group, local))
        _update(optimizer, masters)
        return C.all_reduce(loss, group, "MEAN")

    return step


def build_train_step_with_state(loss_fn: Callable,
                                optimizer: torch.optim.Optimizer, params,
                                model_state, group=None,
                                sync_model_state: bool = True,
                                accum_steps: int = 1,
                                compute_dtype=None) -> Callable:
    """:func:`build_train_step` for a model with state that is not trained
    (BatchNorm running statistics).

    The model state is a tree of tensors beside the parameter tree: for an
    ``nn.Module``, ``params = dict(model.named_parameters())`` and
    ``model_state = dict(model.named_buffers())``, and ``loss_fn`` runs
    the module on both through ``torch.func.functional_call``.
    ``loss_fn(params, model_state, batch) -> (loss, new_model_state)``
    must leave the ``model_state`` it is given as it was and return the
    new state as new tensors.  ``step(global_batch, local=False) -> mean
    loss`` takes the batch as :func:`build_train_step` does, updates
    ``params`` through the optimizer and copies the new state into
    ``model_state`` in place, so a module whose buffers they are holds
    the trained statistics after each step.

    ``accum_steps > 1``: the gradients accumulate as in
    :func:`build_train_step`; the model state threads through the
    microbatches in order (each sees the previous one's statistics, as
    running them as separate steps would).  ``sync_model_state``: the new
    state is averaged over the group after the step, in one all-reduce
    per dtype (the per-leaf all-reduces of the JAX step, which XLA
    combines; eager NCCL would pay a call per buffer).  Each rank
    normalises with its own batch statistics; what is averaged is the
    updated running statistics, not the batch statistics, as the JAX step
    does (not ``nn.SyncBatchNorm``).  ``compute_dtype`` casts the
    parameters as in :func:`build_train_step`; the state stays as it is.
    """
    masters, grads_of = _accum_grads_fn(loss_fn, params, accum_steps,
                                        compute_dtype, has_aux=True)

    def step(global_batch, local: bool = False):
        loss, new = grads_of(_rank_batch(global_batch, group, local),
                             model_state)
        _update(optimizer, masters)
        if sync_model_state:
            new = ops.fused_all_reduce(new, group, "MEAN")
        with torch.no_grad():
            for t, n in zip(tree_leaves(model_state), tree_leaves(new)):
                t.copy_(n)
        return C.all_reduce(loss, group, "MEAN")

    return step
