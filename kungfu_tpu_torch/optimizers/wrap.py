"""How the port's distributed optimizers wrap a ``torch.optim.Optimizer``.

The JAX package builds each one as an optax transformation over the
base's; the port grafts a new ``step()`` onto the base optimizer object
by swapping its class for a subclass, so the optimizer keeps its type,
its parameter groups and its state.  Wrappers nest as optax chains do:
``synchronous_averaging(gradient_noise_scale(Adam(...)))`` runs SMA's
step, which runs the monitor's, which runs Adam's.  The "params" of the
JAX ``update`` are the tensors the optimizer holds, read before the base
step changes them in place.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch


def params_of(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


def grads_of(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p.grad for p in params_of(opt) if p.grad is not None]


def set_grads(opt: torch.optim.Optimizer, grads) -> None:
    """Make ``grads`` (in :func:`grads_of` order) the parameters'
    ``.grad``."""
    it = iter(grads)
    for p in params_of(opt):
        if p.grad is not None:
            p.grad = next(it)


def pull_toward(params, target, coef: float):
    """``coef * (target - p)`` for each parameter, computed in place in
    ``target`` (fresh tensors, e.g. a collective's result)."""
    torch._foreach_sub_(target, params)
    torch._foreach_mul_(target, coef)
    return target


def _like(value, current):
    """A loaded state on the devices of the ``current`` one."""
    if isinstance(current, tuple):              # a NamedTuple of tensors
        return type(current)(*(t.to(c.device)
                               for t, c in zip(value, current)))
    return dict(value)


def wrap(base: torch.optim.Optimizer,
         step: Callable[[torch.optim.Optimizer, Callable], object],
         key: Optional[str] = None, state=None,
         attrs: Optional[dict] = None) -> torch.optim.Optimizer:
    """``base`` with ``step()`` replaced by ``step(opt, base_step)``, run
    under ``torch.no_grad``; ``base_step()`` runs the wrapped optimizer's
    own step and returns its result.

    ``key``: the wrapper keeps ``state`` (a NamedTuple of tensors, or a
    dict of numbers) in the attribute ``opt.<key>``, and
    ``state_dict()`` / ``load_state_dict()`` carry it under ``key``.
    ``attrs``: further class attributes (properties that read the
    state).  Returns ``base``."""
    cls = base.__class__

    def new_step(self, closure=None):
        with torch.no_grad():
            return step(self, lambda: cls.step(self, closure))

    ns = {"step": new_step, **(attrs or {})}
    if key is not None:
        if hasattr(base, key):
            raise ValueError(f"the optimizer already carries {key!r}: "
                             f"a wrapper of this kind is applied once")

        def state_dict(self):
            sd = cls.state_dict(self)
            sd[key] = getattr(self, key)
            return sd

        def load_state_dict(self, sd):
            sd = dict(sd)
            setattr(self, key, _like(sd.pop(key), getattr(self, key)))
            cls.load_state_dict(self, sd)

        ns.update(state_dict=state_dict, load_state_dict=load_state_dict)
        setattr(base, key, state)
    base.__class__ = type(cls.__name__, (cls,), ns)
    return base
