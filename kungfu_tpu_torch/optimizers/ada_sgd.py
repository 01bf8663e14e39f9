"""Adaptive SGD: model averaging first, synchronous SGD after
(counterpart of kungfu_tpu/optimizers/ada_sgd.py).

Steps before ``change_step`` apply the local gradients plus SMA's pull;
at ``change_step`` every replica snaps to the group's mean parameters
(the pull is ``mean - p``) and applies the mean-gradient update; after
it, the mean gradient and no pull.  The snap is to the mean, not a
broadcast of rank 0's parameters, as the JAX code does.  With a stateful
base (Adam) the moments built during SMA differ across ranks, so the
replicas drift apart again after the switch, as in JAX.

Eager PyTorch has no static collective schedule, so each step issues
only the collectives its phase needs (the parameters' mean before and at
the switch, the gradients' mean at and after it); the JAX step issues
both every step and selects.
"""
from __future__ import annotations

import torch

from .. import ops
from .sync_sgd import cross_replica_mean_gradients, synchronous_sgd
from .wrap import grads_of, params_of, pull_toward, wrap


def adaptive_sgd(base: torch.optim.Optimizer, change_step: int,
                 alpha: float = 0.1, group=None,
                 static_phase: str = None) -> torch.optim.Optimizer:
    """AdaptiveSGDOptimizer.  ``static_phase="sma"`` / ``"sgd"`` returns
    :func:`synchronous_averaging` / :func:`synchronous_sgd` of ``base``
    (one phase for the whole run); None switches at ``change_step``.
    The step count is ``state_dict()["adaptive_sgd"]["step"]``."""
    if static_phase == "sma":
        from .sma import synchronous_averaging
        return synchronous_averaging(base, alpha=alpha, group=group)
    if static_phase == "sgd":
        return synchronous_sgd(base, group=group)
    if static_phase is not None:
        raise ValueError(f"static_phase must be None|'sma'|'sgd', "
                         f"got {static_phase!r}")

    def step(opt, base_step):
        t = opt.adaptive_sgd["step"]
        params, pull = params_of(opt), None
        if t <= change_step:
            pull = pull_toward(params, ops.fused_all_reduce(
                params, group, "MEAN"), alpha if t < change_step else 1.0)
        if t >= change_step:
            cross_replica_mean_gradients(grads_of(opt), group, fusion=True)
        out = base_step()
        if pull is not None:
            torch._foreach_add_(params, pull)
        opt.adaptive_sgd = {"step": t + 1}
        return out

    return wrap(base, step, "adaptive_sgd", {"step": 0})
