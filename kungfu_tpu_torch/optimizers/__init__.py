"""Distributed optimizers (counterpart of kungfu_tpu/optimizers): each
wraps a ``torch.optim.Optimizer`` in place (:mod:`.wrap`).  The JAX
package's ``AsyncPairAverager`` is not ported yet."""
from .ada_sgd import adaptive_sgd
from .monitors import (GradVarianceState, NoiseScaleState,
                       gradient_noise_scale, gradient_variance)
from .pair_avg import pair_averaging
from .sma import synchronous_averaging
from .sync_sgd import cross_replica_mean_gradients, synchronous_sgd

# Reference class-name aliases for discoverability.
SynchronousSGDOptimizer = synchronous_sgd
SynchronousAveragingOptimizer = synchronous_averaging
PairAveragingOptimizer = pair_averaging
AdaptiveSGDOptimizer = adaptive_sgd
MonitorGradientNoiseScaleOptimizer = gradient_noise_scale
MonitorGradientVarianceOptimizer = gradient_variance

__all__ = [
    "synchronous_sgd", "synchronous_averaging", "pair_averaging",
    "adaptive_sgd", "gradient_noise_scale", "gradient_variance",
    "cross_replica_mean_gradients", "NoiseScaleState", "GradVarianceState",
    "SynchronousSGDOptimizer", "SynchronousAveragingOptimizer",
    "PairAveragingOptimizer", "AdaptiveSGDOptimizer",
    "MonitorGradientNoiseScaleOptimizer", "MonitorGradientVarianceOptimizer",
]
