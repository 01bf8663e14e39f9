"""Step-based cluster-size schedules (a copy of
kungfu_tpu/elastic/schedule.py).

Reference: KungfuStepBasedSchedule — parses "np:steps,np:steps,..." into a
piecewise-constant cluster size over training steps
(srcs/cpp/src/tensorflow/ops/cpu/elastic.cpp:16-82) and
tests/python/integration/gen_schedule.py.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Stage:
    size: int
    steps: int


class StepSchedule:
    """Piecewise-constant size schedule; size 0 terminates training."""

    def __init__(self, stages: List[Stage]):
        if not stages:
            raise ValueError("empty schedule")
        self.stages = stages

    @staticmethod
    def parse(spec: str) -> "StepSchedule":
        stages = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            size_s, steps_s = part.split(":")
            stages.append(Stage(int(size_s), int(steps_s)))
        return StepSchedule(stages)

    def total_steps(self) -> int:
        return sum(s.steps for s in self.stages)

    def size_at(self, step: int) -> Optional[int]:
        """Cluster size for ``step``; None when the schedule is exhausted."""
        acc = 0
        for s in self.stages:
            acc += s.steps
            if step < acc:
                return s.size
        return None

    def changes(self) -> List[Tuple[int, int]]:
        """(step, new_size) pairs at which the size changes."""
        out = []
        acc = 0
        prev = None
        for s in self.stages:
            if s.size != prev:
                out.append((acc, s.size))
                prev = s.size
            acc += s.steps
        return out

    def to_string(self) -> str:
        return ",".join(f"{s.size}:{s.steps}" for s in self.stages)
