"""Elastic training whose membership the config server drives
(counterpart of kungfu_tpu/elastic/multiproc.py, voluntary resizes only).

Every ``poll_every`` steps each rank fetches the config server's version,
and the ranks all-reduce MAX the latest version any of them has seen (the
version fence): every member then agrees whether to step or to resize
first.  When the agreed version is newer than the membership's, every
rank fetches the server's cluster at that version or later and the
trainer moves to it through :class:`~.trainer.ElasticTrainer`'s one
resize path, at the server's version (the watcher spawns the newcomers
with that version, so they meet the survivors at its rendezvous).

Not ported here: recovery from a rank killed mid-step (the JAX trainer's
``_recover`` over its recoverable runtime; a dead peer fails or hangs a
``torch.distributed`` collective, and the group must be aborted), the
commit cadence and its background committer, the liveness heartbeat.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..launcher import env as E
from . import state as _flags
from .config_server import fetch_config
from .trainer import ElasticTrainer

# seconds every rank gives the config server to reach the version the
# fence agreed on before the resize fails
FETCH_DEADLINE_S = 60.0


class DistributedElasticTrainer(ElasticTrainer):
    """:class:`~.trainer.ElasticTrainer` for a worker the launcher
    started: its membership, version, config server and rendezvous come
    from its :class:`~kungfu_tpu_torch.launcher.env.WorkerEnv` (default:
    the installed one).  ``step()`` fences and resizes as the module
    docstring says, and returns None once this rank is detached."""

    def __init__(self, loss_fn: Callable, optimizer_factory: Callable,
                 init_params, env: Optional[E.WorkerEnv] = None,
                 poll_every: int = 1, backend: Optional[str] = None,
                 init_model_state=None,
                 compute_dtype: Optional[torch.dtype] = None,
                 microbatch: Optional[int] = None):
        we = env if env is not None else E.installed()
        if we.singleton:
            raise RuntimeError("DistributedElasticTrainer needs a worker "
                               "description (--kf-rank, --kf-peers, ...); "
                               "for a fixed group use ElasticTrainer")
        self.we = we
        self.poll_every = max(1, int(poll_every))
        self._last_seen_version = we.cluster_version
        super().__init__(loss_fn, optimizer_factory, init_params,
                         peers=we.peers, rank=we.rank(),
                         version=we.cluster_version,
                         rendezvous=we.rendezvous, backend=backend,
                         config_server_url=we.config_server,
                         init_model_state=init_model_state,
                         compute_dtype=compute_dtype, microbatch=microbatch)
        # the config server bounds the cluster, not the membership this
        # rank joined (a policy reads max_size as the trainer's cap)
        self.max_size = None

    def _fetch_version(self) -> int:
        if not self.config_server_url:
            return self.version
        try:
            return fetch_config(self.config_server_url)[0]
        except (OSError, ValueError, KeyError):
            # a transient failure only delays a resize to the next poll
            return self._last_seen_version

    def _resize_to_server(self, agreed: int) -> None:
        """Every rank fetches the cluster at version ``agreed`` or later;
        once they all hold the same version, move to its workers."""
        target = agreed
        while True:
            t_end = time.monotonic() + FETCH_DEADLINE_S
            while True:
                version, cluster = fetch_config(
                    self.config_server_url, deadline=FETCH_DEADLINE_S)
                if version >= target:
                    break
                if time.monotonic() > t_end:
                    raise TimeoutError(f"config server still at version "
                                       f"{version}, the fence agreed on "
                                       f"{target}")
                time.sleep(0.05)
            top = self._agree(version, "MAX")
            if self._agree(version, "MIN") == top:
                break
            target = top          # the server moved on while we fetched
        self.config_version = version
        self._reform(cluster.workers, version)

    def step(self, global_batch) -> Optional[float]:
        """One fenced elastic step; None once this rank is detached."""
        if _flags.is_detached():
            return None
        while True:
            local = (self._fetch_version()
                     if self.step_count % self.poll_every == 0
                     else self._last_seen_version)
            self._last_seen_version = max(self._last_seen_version, local)
            agreed = self._agree(self._last_seen_version, "MAX")
            self._last_seen_version = max(self._last_seen_version, agreed)
            if agreed <= self.version:
                break
            self._resize_to_server(agreed)
            if _flags.is_detached():
                return None
            # fence again on the new membership before stepping: a
            # newcomer's first fence pairs with everyone's
        return super().step(global_batch)

    def resize(self, new_size: int) -> bool:
        """In a launcher-driven job a resize is a proposal: rank 0 PUTs the
        resized cluster (:meth:`propose_new_size`) and every member applies
        it at its next fence; the other ranks return False."""
        return self.rank == 0 and self.propose_new_size(new_size)

    @property
    def size(self) -> int:
        return self.n

    def propose_new_size(self, n: int) -> bool:
        """PUT a resized cluster to the config server (a CAS on the
        fetched version); every member picks it up at its next fence."""
        from .. import propose_new_size
        return propose_new_size(n, url=self.config_server_url)

    def shutdown(self) -> None:
        if not _flags.is_detached():
            super().shutdown()
