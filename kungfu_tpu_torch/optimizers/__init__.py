"""Distributed optimizers (counterpart of kungfu_tpu/optimizers).  Only
synchronous SGD is ported so far; SMA, pair averaging, adaptive SGD and
the monitors come with the optimizer-family slice."""
from .sync_sgd import (cross_replica_mean_gradients,  # noqa: F401
                       synchronous_sgd)
