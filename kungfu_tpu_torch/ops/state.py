"""Stateful helper ops: a counter and an exponential moving average
(counterpart of kungfu_tpu/ops/state.py).

The carried-state form keeps its state in 0-d tensors: ``*_init()``
builds the state and ``*_update(state, ...) -> (out, new_state)``
returns new tensors and leaves its inputs as they are, so an update
needs no host synchronisation.  The host classes :class:`Counter` and
:class:`ExponentialMovingAverage` are the eager form for step loops
(schedules, hooks).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "CounterState", "counter_init", "counter_update", "Counter",
    "EmaState", "ema_init", "ema_update", "ExponentialMovingAverage",
]


class CounterState(NamedTuple):
    count: torch.Tensor      # int32, 0-d


def counter_init(init: int = 0) -> CounterState:
    return CounterState(torch.tensor(init, dtype=torch.int32))


def counter_update(state: CounterState, incr: int = 1
                   ) -> Tuple[torch.Tensor, CounterState]:
    """Returns the *current* count, then advances: the first call yields
    ``init``."""
    return state.count, CounterState(state.count + incr)


class EmaState(NamedTuple):
    initialized: torch.Tensor    # bool, 0-d
    value: torch.Tensor          # f32, 0-d (or the shape of ``like``)


def ema_init(like=0.0) -> EmaState:
    """The state for values shaped like ``like``, on its device."""
    v = torch.as_tensor(like, dtype=torch.float32)
    return EmaState(torch.tensor(False, device=v.device), torch.zeros_like(v))


def ema_update(state: EmaState, x, alpha: float = 0.9
               ) -> Tuple[torch.Tensor, EmaState]:
    """The first sample seeds the average; after that
    ``v <- alpha * v + (1 - alpha) * x``."""
    x = torch.as_tensor(x, dtype=state.value.dtype,
                        device=state.value.device)
    new = torch.where(state.initialized,
                      alpha * state.value + (1.0 - alpha) * x, x)
    return new, EmaState(torch.ones_like(state.initialized), new)


class Counter:
    """Eager host counter: each call returns the current value, then
    increments."""

    def __init__(self, init: int = 0, incr: int = 1):
        self._count = int(init)
        self._incr = int(incr)

    def __call__(self) -> int:
        c = self._count
        self._count += self._incr
        return c


class ExponentialMovingAverage:
    """Eager host EMA of floats, the recurrence of :func:`ema_update`."""

    def __init__(self, alpha: float = 0.9):
        self._alpha = float(alpha)
        self._value: Optional[float] = None

    def __call__(self, x: float) -> float:
        if self._value is None:
            self._value = float(x)
        else:
            self._value = (self._alpha * self._value
                           + (1 - self._alpha) * float(x))
        return self._value

    @property
    def value(self) -> Optional[float]:
        return self._value
