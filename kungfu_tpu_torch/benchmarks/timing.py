"""Timing of device work, shared by the roofline and ``chip_smoke.py``.

On the card a run is timed with CUDA events: the L2 cache is flushed
before it (in a training or decode step the other layers' tensors pass
through L2 between two calls of one kernel), and a spin kernel keeps the
card busy while the host enqueues the run, so the events time the device
work and not the host's launch overhead.  ``reps`` back-to-back calls go
between the two events, so that one run outlasts the events' resolution.
On the CPU a run is timed with ``time.perf_counter``.
"""
from __future__ import annotations

import statistics
import time

import torch


class Timer:
    """``timer(fn, reps=n)``: the median over ``runs`` runs of one call's
    time in ms, where a run is ``reps`` calls of ``fn`` after ``warmup``
    untimed calls.  The flush zeroes 96 MB, so L2 is left full of dirty
    lines that a read-bound run writes back as it misses; with
    ``read_flush=True`` the flush reads the buffer instead and leaves L2
    clean (the difference is what that write-back costs the run)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.flush = (torch.empty(96 << 20, dtype=torch.uint8,
                                  device=self.device)
                      if self.device.type == "cuda" else None)

    def __call__(self, fn, warmup: int = 3, runs: int = 25,
                 reps: int = 1, read_flush: bool = False) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(runs):
            if self.flush is None:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                times.append((time.perf_counter() - t0) * 1e3 / reps)
                continue
            if read_flush:
                self.flush.sum()
            else:
                self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)
