"""Synchronous model averaging, SMA (counterpart of
kungfu_tpu/optimizers/sma.py).

Each step every rank pulls its parameters toward the group's mean and
applies its own local gradient update:
``p <- p + u_local + alpha * (mean(p) - p)``, where the mean and the pull
are taken from the parameters before the base step.  Communication is
over the parameters, not the gradients.
"""
from __future__ import annotations

import torch

from .. import ops
from .wrap import params_of, pull_toward, wrap


def synchronous_averaging(base: torch.optim.Optimizer, alpha: float = 0.1,
                          group=None) -> torch.optim.Optimizer:
    """SynchronousAveragingOptimizer: ``base``, whose ``step()`` takes
    the parameters' mean over ``group`` (one all-reduce per dtype), runs
    the base update on the local gradients and adds
    ``alpha * (mean - p)`` from before it.  Every rank must call
    ``step()``."""
    def step(opt, base_step):
        params = params_of(opt)
        pull = pull_toward(params, ops.fused_all_reduce(params, group,
                                                        "MEAN"), alpha)
        out = base_step()
        torch._foreach_add_(params, pull)
        return out

    return wrap(base, step)
