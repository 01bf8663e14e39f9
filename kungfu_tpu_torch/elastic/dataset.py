"""Elastic dataset sharding (a copy of kungfu_tpu/elastic/dataset.py).

Reference: srcs/python/kungfu/tensorflow/v1/datasets/adaptor.py:4-33 —
BaseDatasetAdaptor skips already-consumed samples and shards the rest by
(rank, cluster size); after every resize the shard assignment changes but
global progress is preserved.
"""
from __future__ import annotations

import numpy as np


class ElasticDataShard:
    """Deterministic global-order sharding that survives resizes."""

    def __init__(self, num_samples: int, seed: int = 0,
                 shuffle_each_epoch: bool = True):
        self.num_samples = num_samples
        self.seed = seed
        self.shuffle = shuffle_each_epoch

    def _order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.num_samples)
        rng = np.random.RandomState(self.seed + epoch)
        return rng.permutation(self.num_samples)

    def batch_indices(self, trained_samples: int, global_batch: int
                      ) -> np.ndarray:
        """Indices of the next global batch given total progress.

        All peers compute the same answer from the shared progress counter,
        so a resize never skips or repeats samples.
        """
        epoch = trained_samples // self.num_samples
        offset = trained_samples % self.num_samples
        parts = []
        need = global_batch
        while need > 0:  # a batch may span any number of epochs
            order = self._order(epoch)
            take = order[offset:offset + need]
            parts.append(take)
            need -= len(take)
            epoch += 1
            offset = 0
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def local_slice(self, indices: np.ndarray, rank: int, size: int
                    ) -> np.ndarray:
        """This worker's share of a global batch.

        The remainder when ``len(indices) % size != 0`` is spread over the
        first ranks so no sample is dropped (the no-skip guarantee holds
        for any global-batch/cluster-size combination).
        """
        per, rem = divmod(len(indices), size)
        begin = rank * per + min(rank, rem)
        end = begin + per + (1 if rank < rem else 0)
        return indices[begin:end]
