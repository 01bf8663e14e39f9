"""Training policies: callbacks around the elastic training loop
(a copy of kungfu_tpu/elastic/policy.py).

Reference: srcs/python/kungfu/policy/base_policy.py:5-31 (BasePolicy with
before/after train/epoch/step callbacks) and policy_hook.py:8-77 (the hook
that drives policies with trained-sample accounting).  The noise-scale
policy reads the port's monitor (``opt.noise_scale``,
``kungfu_tpu_torch.optimizers.gradient_noise_scale``) where the JAX one
walks the optax state.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class BasePolicy:
    """Subclass and override any of the callbacks."""

    def before_train(self, ctx): ...
    def after_train(self, ctx): ...
    def before_epoch(self, ctx): ...
    def after_epoch(self, ctx): ...
    def before_step(self, ctx): ...
    def after_step(self, ctx): ...


class PolicyContext:
    """What policies see/do: progress counters + cluster control."""

    def __init__(self, trainer=None, total_samples: int = 0):
        self.trainer = trainer
        self.total_samples = total_samples
        self.trained_samples = 0
        self.epoch = 0
        self.step = 0
        self._requested_size: Optional[int] = None
        self.stopped = False

    # policy-visible controls -------------------------------------------------
    def resize(self, new_size: int) -> None:
        self._requested_size = new_size

    def request_stop(self) -> None:
        self.stopped = True

    @property
    def cluster_size(self) -> int:
        return self.trainer.n if self.trainer else 1


class PolicyRunner:
    """Drives policies around an ElasticTrainer training loop
    (reference: PolicyHook)."""

    def __init__(self, policies: Sequence[BasePolicy], trainer,
                 epoch_size: int, epochs: int):
        self.policies = list(policies)
        self.trainer = trainer
        self.epoch_size = epoch_size
        self.epochs = epochs
        self.ctx = PolicyContext(trainer, total_samples=epoch_size * epochs)

    def _fire(self, name: str) -> None:
        for p in self.policies:
            getattr(p, name)(self.ctx)
        if self.ctx._requested_size is not None:
            size = self.ctx._requested_size
            self.ctx._requested_size = None
            self.trainer.resize(size)

    def run(self, batch_fn, steps_per_epoch: int) -> List[float]:
        """batch_fn(trainer) -> global batch for the current cluster size.

        ``ctx.step`` is the trainer's step count, so a rank that joined a
        running job, or resumed from a checkpoint, reads the job's step
        (one controller's count is the job's in the JAX package)."""
        losses = []
        self.ctx.step = self.trainer.step_count
        self._fire("before_train")
        for e in range(self.epochs):
            self.ctx.epoch = e
            self._fire("before_epoch")
            for _ in range(steps_per_epoch):
                self._fire("before_step")
                if self.ctx.stopped:
                    break
                loss = self.trainer.step(batch_fn(self.trainer))
                if loss is None:        # this rank was detached
                    self.ctx.request_stop()
                    break
                losses.append(loss)
                self.ctx.step = self.trainer.step_count
                self.ctx.trained_samples = self.trainer.trained_samples
                self._fire("after_step")
            self._fire("after_epoch")
            if self.ctx.stopped:
                break
        self._fire("after_train")
        return losses


class ScheduledResizePolicy(BasePolicy):
    """Resize according to a StepSchedule — the reference's elastic test
    driver (gen_schedule.py + KungfuStepBasedSchedule)."""

    def __init__(self, schedule):
        self.schedule = schedule

    def before_step(self, ctx):
        size = self.schedule.size_at(ctx.step)
        if size is None or size == 0:
            ctx.request_stop()
        elif size != ctx.cluster_size:
            ctx.resize(size)


class GNSScalingPolicy(BasePolicy):
    """Autoscaling from the gradient noise scale.

    The GNS estimates the *critical batch size* — the global batch
    beyond which extra data parallelism stops buying optimization
    progress (An Empirical Model of Large-Batch Training; the same
    estimator the reference monitors with
    MonitorGradientNoiseScaleOptimizer and feeds to its adaptation
    policies).  This policy closes the loop the reference leaves to the
    user: it reads the live GNS off the optimizer state and proposes a
    cluster size such that ``size * per_lane_batch`` tracks it.

    Guard rails (a resize costs seconds of recompile/re-sync —
    benchmarks/resize_cost):

    - ``warmup_steps`` before the EMA estimator is trusted at all;
    - a proposal only every ``check_every`` steps;
    - a deadband: resize only when the wanted size differs from the
      current one by at least ``deadband`` (ratio, default 1.5x either
      way), so noise can't thrash the cluster;
    - ``cooldown_steps`` after each resize;
    - hard [min_size, max_size] clamp, and the trainer's own ``max_size``
      where it has one (a launcher-driven trainer has none, since the
      config server bounds its cluster: give this policy ``max_size``,
      or it proposes nothing).

    Use with an optimizer chain containing
    ``optimizers.gradient_noise_scale`` (any nesting: the wrapper exposes
    ``opt.noise_scale`` on the outermost optimizer).  NOTE the monitor's
    ``batch_size`` is the PER-RANK batch (its B_small; it derives B_big =
    n * B_small itself) — the same number this policy takes::

        factory = lambda leaves, n: O.gradient_noise_scale(
            O.synchronous_sgd(torch.optim.SGD(leaves, lr=0.1)),
            batch_size=PER_RANK)
        trainer = ElasticTrainer(loss, factory, params, peers, rank)
        PolicyRunner([GNSScalingPolicy(PER_RANK, max_size=8)],
                     trainer, ...).run(...)
    """

    def __init__(self, per_lane_batch: int, min_size: int = 1,
                 max_size: Optional[int] = None, check_every: int = 10,
                 warmup_steps: int = 20, cooldown_steps: int = 50,
                 deadband: float = 1.5):
        if per_lane_batch <= 0:
            raise ValueError("per_lane_batch must be positive")
        if deadband < 1.0:
            raise ValueError("deadband is a ratio >= 1.0")
        if max_size is not None and min_size > max_size:
            raise ValueError(f"min_size {min_size} > max_size {max_size}")
        self.per_lane_batch = per_lane_batch
        self.min_size = min_size
        self.max_size = max_size
        self.check_every = max(1, check_every)
        self.warmup_steps = warmup_steps
        self.cooldown_steps = cooldown_steps
        self.deadband = deadband
        self._last_resize_step: Optional[int] = None
        self.history: List[tuple] = []   # (step, gns, proposed or None)

    def _cap(self, ctx) -> Optional[int]:
        caps = [self.max_size,
                # never propose beyond what the trainer can install
                getattr(ctx.trainer, "max_size", None)]
        real = [c for c in caps if c is not None]
        if not real:
            return None
        cap = min(real)
        return None if cap < self.min_size else cap

    def after_step(self, ctx):
        if ctx.step < self.warmup_steps or ctx.step % self.check_every:
            return
        if (self._last_resize_step is not None
                and ctx.step - self._last_resize_step < self.cooldown_steps):
            return
        trainer = ctx.trainer
        ns = getattr(getattr(trainer, "optimizer", None), "noise_scale",
                     None)
        if ns is None:
            return
        gns = float(ns)
        cap = self._cap(ctx)
        if not (gns > 0) or cap is None:   # estimator unsettled/NaN, or
            self.history.append((ctx.step, gns, None))  # floor > capacity
            return
        cur = ctx.cluster_size
        # deadband on the RAW demand, clamp after: a huge GNS must still
        # reach max_size from a nearby size (clamping first would make
        # the band test want-vs-cur and saturate below the cap forever).
        # A cluster OUTSIDE the [min_size, cap] bounds is always pulled
        # back in — bounds are hard, the deadband only damps noise.
        raw = max(1, round(gns / self.per_lane_batch))
        want = int(np.clip(raw, self.min_size, cap))
        out_of_bounds = cur < self.min_size or cur > cap
        if want != cur and (out_of_bounds
                            or raw >= cur * self.deadband
                            or raw <= cur / self.deadband):
            self.history.append((ctx.step, gns, want))
            self._last_resize_step = ctx.step
            ctx.resize(want)
        else:
            self.history.append((ctx.step, gns, None))
