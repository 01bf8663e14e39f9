"""Monitoring optimizers: the gradient noise scale and the cross-rank
gradient variance (counterpart of kungfu_tpu/optimizers/monitors.py).

Both compute their statistic from the local gradients (batch B per rank)
and their mean over the group (batch n B), in one all-reduce per dtype
that also carries each rank's local squared norm, and keep it as 0-d f32
tensors on the parameters' device: ``opt.noise_scale`` /
``opt.variance`` (readable through any wrapper around them), and the
states :class:`NoiseScaleState` / :class:`GradVarianceState` under the
keys ``"gradient_noise_scale"`` / ``"gradient_variance"`` of
``opt.state_dict()``.  Squared norms are f32 sums over the parameters in
order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import ops
from .wrap import grads_of, params_of, set_grads, wrap


class NoiseScaleState(NamedTuple):
    ema_s: torch.Tensor          # EMA of the gradient noise, S
    ema_g2: torch.Tensor         # EMA of the true gradient's |G|^2
    noise_scale: torch.Tensor
    step: torch.Tensor           # int32


class GradVarianceState(NamedTuple):
    variance: torch.Tensor
    step: torch.Tensor           # int32


# a saved state_dict() loads with torch.load's default weights_only=True
torch.serialization.add_safe_globals([NoiseScaleState, GradVarianceState])


def _sq_norm(flat: dict, skip_last: str) -> torch.Tensor:
    """The f32 squared norm of the fused buffers, without the last
    element of buffer ``skip_last`` (the statistic's slot)."""
    total = None
    for dt in sorted(flat):
        v = flat[dt][:-1] if dt == skip_last else flat[dt]
        v = v.float()
        total = v.dot(v) if total is None else total + v.dot(v)
    return total


def mean_and_sq_norms(grads, group=None):
    """``(mean, g2_small, g2_big)``: the gradients' mean over the group,
    the mean over ranks of each rank's local squared norm (so every rank
    agrees) and the squared norm of the mean.  One all-reduce per dtype:
    the local squared norm rides in an extra f32 slot of the fused
    buffer."""
    slot = torch.zeros(1, dtype=torch.float32, device=grads[0].device)
    flat, spec = ops.fuse(list(grads) + [slot])
    f32 = str(torch.float32)
    flat[f32][-1] = _sq_norm(flat, f32)
    n = dist.get_world_size(group)
    for dt in sorted(flat):
        dist.all_reduce(flat[dt], group=group)
        flat[dt].div_(n)
    mean = ops.defuse(flat, spec)[:-1]
    return mean, flat[f32][-1], _sq_norm(flat, f32)


def gradient_noise_scale(base: torch.optim.Optimizer, batch_size: int,
                         group=None, ema_decay: float = 0.95,
                         apply: str = "mean") -> torch.optim.Optimizer:
    """MonitorGradientNoiseScaleOptimizer: the simple noise scale of An
    Empirical Model of Large-Batch Training.  With B_small =
    ``batch_size`` (per rank) and B_big = n B_small,

        |G|^2_est = (B_big |g_big|^2 - B_small |g_small|^2)
                    / max(B_big - B_small, 1)
        S_est     = (|g_small|^2 - |g_big|^2)
                    / max(1/B_small - 1/B_big, 1e-12)
        noise_scale = EMA(S) / EMA(|G|^2)

    (the first step seeds both EMAs; at one rank the noise scale is 0).
    ``apply``: the base update consumes the mean gradient (``"mean"``,
    synchronous SGD) or this rank's own (``"local"``, for model-averaging
    wrappers such as SMA around it)."""
    if apply not in ("mean", "local"):
        raise ValueError(f"apply must be 'mean' or 'local', got {apply!r}")
    b_small, d = float(batch_size), ema_decay
    z = torch.zeros((), dtype=torch.float32,
                    device=params_of(base)[0].device)

    def step(opt, base_step):
        g_mean, g2_small, g2_big = mean_and_sq_norms(grads_of(opt), group)
        b_big = b_small * dist.get_world_size(group)
        g2_est = ((b_big * g2_big - b_small * g2_small)
                  / max(b_big - b_small, 1.0))
        s_est = (g2_small - g2_big) / max(1 / b_small - 1 / b_big, 1e-12)
        st = opt.gradient_noise_scale
        first = st.step == 0
        ema_s = torch.where(first, s_est, d * st.ema_s + (1 - d) * s_est)
        ema_g2 = torch.where(first, g2_est,
                             d * st.ema_g2 + (1 - d) * g2_est)
        noise = ema_s / ema_g2.masked_fill(ema_g2.abs() < 1e-30, 1e-30)
        opt.gradient_noise_scale = NoiseScaleState(ema_s, ema_g2, noise,
                                                   st.step + 1)
        if apply == "mean":
            set_grads(opt, g_mean)
        return base_step()

    return wrap(base, step, "gradient_noise_scale",
                NoiseScaleState(z, z, z, z.to(torch.int32)),
                {"noise_scale": property(
                    lambda self: self.gradient_noise_scale.noise_scale)})


def gradient_variance(base: torch.optim.Optimizer, group=None
                      ) -> torch.optim.Optimizer:
    """MonitorGradientVarianceOptimizer: the cross-rank gradient variance
    ``max(E_i |g_i|^2 - |E_i g_i|^2, 0)``; the base update consumes the
    mean gradient."""
    z = torch.zeros((), dtype=torch.float32,
                    device=params_of(base)[0].device)

    def step(opt, base_step):
        g_mean, e_norm2, norm2_e = mean_and_sq_norms(grads_of(opt), group)
        st = opt.gradient_variance
        opt.gradient_variance = GradVarianceState(
            (e_norm2 - norm2_e).clamp_min(0.0), st.step + 1)
        set_grads(opt, g_mean)
        return base_step()

    return wrap(base, step, "gradient_variance",
                GradVarianceState(z, z.to(torch.int32)),
                {"variance": property(
                    lambda self: self.gradient_variance.variance)})
