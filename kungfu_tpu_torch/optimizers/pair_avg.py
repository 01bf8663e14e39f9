"""Pair averaging, the AD-PSGD family (counterpart of
kungfu_tpu/optimizers/pair_avg.py::pair_averaging).

Each step every rank exchanges its parameters with one partner on a
scheduled ring shift and pulls toward what it received:
``p <- p + u_local + mix * (q - p)``, from the parameters before the base
step.  Step t uses shift ``2^(t mod k) mod n`` with ``k = ceil(log2 n)``
(hypercube gossip: one cycle of k shifts mixes every rank with every
other), through :func:`~kungfu_tpu_torch.comm.collectives.ring_exchange`.
The JAX package's ``AsyncPairAverager`` (over the native p2p store) is
not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..comm import collectives as C
from .wrap import params_of, pull_toward, wrap


def pair_averaging(base: torch.optim.Optimizer, n: int, group=None,
                   mix: float = 0.5) -> torch.optim.Optimizer:
    """PairAveragingOptimizer over a group of ``n`` ranks (checked).  The
    step count is ``state_dict()["pair_averaging"]["step"]``."""
    if n < 1:
        raise ValueError("n must be >= 1")
    size = dist.get_world_size(group)
    if n != size:
        raise ValueError(f"n={n} but the group has {size} ranks")
    k = max(1, math.ceil(math.log2(n)))

    def step(opt, base_step):
        t = opt.pair_averaging["step"]
        params, pull = params_of(opt), None
        if n > 1:
            peer = C.ring_exchange(params, group, (2 ** (t % k)) % n, n)
            pull = pull_toward(params, peer, mix)
        out = base_step()
        if pull is not None:
            torch._foreach_add_(params, pull)
        opt.pair_averaging = {"step": t + 1}
        return out

    return wrap(base, step, "pair_averaging", {"step": 0})
