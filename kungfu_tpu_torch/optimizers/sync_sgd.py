"""Synchronous SGD: gradients averaged over the peers before the base
update (counterpart of kungfu_tpu/optimizers/sync_sgd.py).

The JAX package chains an optax transformation; the port grafts the
average onto any ``torch.optim.Optimizer``, in the manner of the
host-plane bridge's ``SynchronousSGDOptimizer``: the optimizer keeps its
type and ``step()`` first averages every parameter's ``.grad`` over the
group.  ``hierarchical=`` and ``pairs=`` (the graph strategies) come
with the parallel slice of the port.
"""
from __future__ import annotations

from typing import List

import torch

from .. import ops
from ..comm import collectives as C
from .wrap import grads_of, wrap


def cross_replica_mean_gradients(grads: List[torch.Tensor], group=None,
                                 fusion: bool = False) -> None:
    """Replace each tensor of ``grads`` in place by its mean over the
    group; with ``fusion`` one all-reduce per dtype over a fused buffer
    (the reference's nccl_fusion)."""
    if not grads:
        return
    if fusion:
        averaged = ops.fused_all_reduce(list(grads), group, "MEAN")
    else:
        averaged = C.all_reduce(list(grads), group, "MEAN")
    with torch.no_grad():
        for g, a in zip(grads, averaged):
            g.copy_(a)


def synchronous_sgd(base: torch.optim.Optimizer, group=None,
                    fusion: bool = False) -> torch.optim.Optimizer:
    """SynchronousSGDOptimizer: ``base``, whose ``step()`` now averages
    the gradients of all its parameters over ``group`` (None = the
    default group) and then runs the base update.  Every rank must call
    ``step()``, as the average is collective."""
    def step(opt, base_step):
        cross_replica_mean_gradients(grads_of(opt), group, fusion)
        return base_step()

    return wrap(base, step)
