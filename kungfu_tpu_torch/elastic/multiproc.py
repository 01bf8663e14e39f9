"""Elastic training whose membership the config server drives, and which
survives a rank killed mid-step (counterpart of
kungfu_tpu/elastic/multiproc.py).

Every ``poll_every`` steps each rank fetches the config server's version,
and the ranks all-reduce MAX the latest version any of them has seen (the
version fence): every member then agrees whether to step or to resize
first.  When the agreed version is newer than the membership's, every
rank fetches the server's cluster at that version or later and the
trainer moves to it through :class:`~.trainer.ElasticTrainer`'s one
resize path, at the server's version (the watcher spawns the newcomers
with that version, so they meet the survivors at its rendezvous).

Commits.  Every ``snapshot_every`` steps (or at a cadence derived from
the first measured commit, ``"auto"``) the trainer initiates a commit:
its parameters, model state and ``optimizer.state_dict()`` are copied to
pinned host buffers on a side stream, and a background committer
publishes them with the ``(trained_samples, step_count)`` pair that
describes them (:class:`~.snapshot.AsyncCommitter`).  The optimizer's
next in-place write waits on the copies first (a step pre-hook).

Recovery.  A rank killed (SIGKILL, SIGTERM) or hung fails the survivors'
collectives; the fence, the step, a commit and a voluntary resize then
call :meth:`DistributedElasticTrainer._recover`, which

1. aborts the broken group (:func:`kungfu_tpu_torch.distributed.abort`);
2. drains the committer (an in-flight commit lands or is dropped);
3. polls the config server until a version newer than the membership's
   exists (the watcher's exclusion of the dead), beating the heartbeat;
   past ``recover_timeout`` it raises the error that started it;
4. returns None when that version drops this rank (detached);
5. waits, with a FileStore rendezvous, until every survivor of that
   version has come, and moves on to a newer version if one appears
   first (a second death the watcher excluded a poll later); then
   re-forms the group at that version, with no consensus over the old
   group (a dead member cannot vote), and checks MIN == MAX of the
   version on the new one;
6. restores the new rank 0's published commit, state and counters
   together: each survivor whose committed pair and bit sums equal rank
   0's restores its own pinned commit, and rank 0 sends its commit only
   to those that differ.  Never a MAX of the live counters: survivors
   can leave the failed collective at different steps;
7. redoes ``step(batch)`` with the caller's batch.  With
   ``snapshot_every`` > 1 this trains the caller's batch on the state of
   the last commit, and the caller draws its next batches from the
   rewound ``step_count``, as the JAX trainer does.

A ``TypeError`` or ``ValueError`` (the caller's mistake) propagates, and
so does an error of this rank's own card (out of memory, a CUDA error:
``LOCAL_ERRORS``), which fails the job at once.
Each recovery appends a record to :attr:`DistributedElasticTrainer.recoveries`.
"""
from __future__ import annotations

import hashlib
import math
import os
import sys
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .. import distributed as D
from ..comm import collectives as C
from ..comm.session import Session
from ..launcher import env as E
from ..plan.peer import PeerList
from ..utils.tree import tree_leaves, tree_map
from . import state as _flags
from .config_server import fetch_config
from .heartbeat import HeartbeatSender
from .snapshot import AsyncCommitter, tree_nbytes
from .trainer import ElasticTrainer

# seconds every rank gives the config server to reach the version the
# fence agreed on before the resize fails
FETCH_DEADLINE_S = 60.0
# the auto cadence's share of a step that a commit's blocking dispatch
# may take (the JAX package's default)
SNAPSHOT_BUDGET = 0.05
# what a dead or hung peer raises in a collective: gloo's RuntimeError
# (torch.distributed.DistBackendError is one), and OSError from the
# config server and the sockets
PEER_ERRORS = (RuntimeError, OSError)
# RuntimeErrors of this rank's own card, not of a peer: raised as they are
LOCAL_ERRORS = (torch.OutOfMemoryError, torch.AcceleratorError)
_RECOVER_POLL_S = 0.05
_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def bit_sums(tree) -> List[torch.Tensor]:
    """The bits of each tensor of ``tree`` summed as integers of its
    element size, in int64: one vector a device, where the tensors lie
    (on the card, kernels queued on the current stream)."""
    by_device = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            flat = t.detach().reshape(-1)
            by_device.setdefault(str(flat.device), []).append(
                flat.view(_INT_OF_SIZE[flat.element_size()]).sum(
                    dtype=torch.int64))
    return [torch.stack(by_device[d]) for d in sorted(by_device)]


def tree_digest(tree, sums) -> int:
    """An int64 over a tree and its :func:`bit_sums` ``sums``: the sums,
    the tensors' shapes and dtypes and the plain values, hashed.  Trees
    of equal bits give equal digests."""
    spec = [f"{tuple(t.shape)}{t.dtype}" if isinstance(t, torch.Tensor)
            else repr(t) for t in tree_leaves(tree)]
    h = hashlib.sha256("|".join(spec).encode())
    for v in sums:
        h.update(v.cpu().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


class DistributedElasticTrainer(ElasticTrainer):
    """:class:`~.trainer.ElasticTrainer` for a worker the launcher
    started: its membership, version, config server and rendezvous come
    from its :class:`~kungfu_tpu_torch.launcher.env.WorkerEnv` (default:
    the installed one).  ``step()`` fences, resizes, commits and recovers
    as the module docstring says, and returns None once this rank is
    detached.

    ``snapshot_every``: commit every that many steps, or ``"auto"``: the
    smallest cadence whose blocking commit cost stays under
    ``SNAPSHOT_BUDGET`` of a step and whose join fits in the cadence
    (measured at the first step, derived at the second, MAX over the
    group).  ``recover_timeout``: seconds a recovery waits for the config
    server's new version.  ``collective_timeout_s``: as in
    :class:`~.trainer.ElasticTrainer`.  ``heartbeat_s``: seconds between
    liveness-lease renewals (None: the worker's ``--kf-heartbeat-s``; 0:
    none)."""

    # whether a commit is a collective (the sharded trainer's replica
    # exchange): then a peer that fails it is recovered from like one
    # that fails the step
    collective_commit = False

    def __init__(self, loss_fn: Callable, optimizer_factory: Callable,
                 init_params, env: Optional[E.WorkerEnv] = None,
                 poll_every: int = 1, backend: Optional[str] = None,
                 init_model_state=None,
                 compute_dtype: Optional[torch.dtype] = None,
                 microbatch: Optional[int] = None, snapshot_every=1,
                 recover_timeout: float = 60.0,
                 collective_timeout_s: float = D.DEFAULT_TIMEOUT_S,
                 heartbeat_s: Optional[float] = None):
        we = env if env is not None else E.installed()
        if we.singleton:
            raise RuntimeError("DistributedElasticTrainer needs a worker "
                               "description (--kf-rank, --kf-peers, ...); "
                               "for a fixed group use ElasticTrainer")
        self.we = we
        self.poll_every = max(1, int(poll_every))
        self._last_seen_version = we.cluster_version
        self.recover_timeout = recover_timeout
        self._auto_snap = snapshot_every == "auto"
        self.snapshot_every = (1 if self._auto_snap
                               else max(1, int(snapshot_every)))
        # the measured commit of the auto cadence: its blocking dispatch
        # and its join (0: not measured by this rank)
        self._auto_commit_s = 0.0
        self._auto_join_s = 0.0
        self._last_step_s: Optional[float] = None
        self._committer = AsyncCommitter()
        # (host tree, devices of its leaves, (samples, steps)) of the
        # last published commit
        self._committed = None
        self.recoveries: List[dict] = []
        self._heartbeat = HeartbeatSender.for_worker(
            we, we.heartbeat_s if heartbeat_s is None else heartbeat_s)
        super().__init__(loss_fn, optimizer_factory, init_params,
                         peers=we.peers, rank=we.rank(),
                         version=we.cluster_version,
                         rendezvous=we.rendezvous, backend=backend,
                         config_server_url=we.config_server,
                         init_model_state=init_model_state,
                         compute_dtype=compute_dtype, microbatch=microbatch,
                         collective_timeout_s=collective_timeout_s)
        # the config server bounds the cluster, not the membership this
        # rank joined (a policy reads max_size as the trainer's cap)
        self.max_size = None
        # the first recovery point: the state every member starts from
        self._commit()
        self._committer.drain()
        # the lease starts once the group has formed: a rank waiting at
        # the rendezvous for a slow peer is not hung (a peer that never
        # renewed is never taken for hung)
        self._beat()

    # ------------------------------------------------------------ commits
    def _install(self, opt_state) -> None:
        super()._install(opt_state)
        # the base update writes the parameters and moments in place: it
        # must wait until a commit's copies of them are done
        self.optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: self._committer.fence())

    def _adopt(self, params, model_state) -> None:
        self._committer.fence()
        super()._adopt(params, model_state)

    def _progress_meta(self) -> dict:
        # a newcomer adopts the membership's cadence, and whether the auto
        # derivation is still pending, with the counters
        return {**super()._progress_meta(),
                "snapshot_every": self.snapshot_every,
                "auto_snap": self._auto_snap}

    def _adopt_progress(self, meta: dict) -> None:
        super()._adopt_progress(meta)
        self.snapshot_every = meta["snapshot_every"]
        self._auto_snap = meta["auto_snap"]

    @property
    def committed_progress(self):
        """``(trained_samples, step_count)`` of the last published commit."""
        rec = self._committed
        return None if rec is None else rec[2]

    def _commit(self) -> None:
        """Initiate a commit of the live state and the counters that
        describe it; it becomes the recovery point when the committer
        publishes it."""
        tree = {"params": self.params, "opt": self.optimizer.state_dict()}
        if self.has_model_state:
            tree["model_state"] = self.model_state
        devices = tree_map(lambda t: t.device if isinstance(
            t, torch.Tensor) else None, tree)
        # the digest a restore compares, computed now on the device: the
        # copies (after these kernels on the side stream) bring it along
        tree["sums"] = bit_sums(tree)
        progress = (self.trained_samples, self.step_count)
        self._committer.initiate(
            tree, lambda host: self._publish(host, devices, progress))

    def _publish(self, host, devices, progress) -> None:
        """Runs on the committer thread once ``host`` is joined: the state
        and its counters become visible in one assignment."""
        self._committed = (host, devices, progress)

    def _measure_commit(self) -> None:
        """One drained commit, split into the blocking dispatch and the
        join that follows (the inputs of the auto cadence)."""
        t0 = time.perf_counter()
        self._commit()
        self._auto_commit_s = time.perf_counter() - t0
        self._committer.drain()
        self._auto_join_s = time.perf_counter() - t0 - self._auto_commit_s

    def _cadence_due(self) -> bool:
        """The auto cadence (kungfu_tpu/elastic/multiproc.py:499-560):
        True when this step must measure a commit (drained); otherwise
        it fixes ``snapshot_every`` once derived.  Collective at the
        derivation."""
        if not self._auto_snap:
            return False
        if self.step_count == 1:
            return True        # measured now; derived at step 2 (warm)
        step_s = max(self._last_step_s or 1e-3, 1e-3)
        # 0: this rank never measured a commit; the MAX adopts a member
        # that did
        cadence = (0 if self._auto_commit_s == 0.0 else max(
            1, math.ceil(self._auto_commit_s
                         / (SNAPSHOT_BUDGET * step_s)),
            math.ceil(self._auto_join_s / step_s)))
        if self.n > 1:
            cadence = self._agree(cadence, "MAX")
        if cadence == 0:
            return True
        self.snapshot_every, self._auto_snap = cadence, False
        if cadence > 1 and self.rank == 0:
            print(f"kft: snapshot_every=auto -> {cadence} (commit "
                  f"{self._auto_commit_s:.3f}s vs step {step_s:.3f}s, "
                  f"budget {SNAPSHOT_BUDGET:.0%})", file=sys.stderr)
        return False

    def _drain_quietly(self, where: str) -> None:
        """Drain on a path that goes on regardless: a failed commit in
        flight is reported, and the previous one stands."""
        try:
            self._committer.drain()
        except Exception as e:
            print(f"kft: in-flight commit abandoned at {where}: {e!r}",
                  file=sys.stderr)

    # ------------------------------------------------------------- fence
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

    def _beat(self) -> None:
        if self._heartbeat is not None:
            self._heartbeat.beat(rank=self.rank, step=self.step_count,
                                 version=self.version)

    def step(self, global_batch) -> Optional[float]:
        """One fenced elastic step; None once this rank is detached."""
        if _flags.is_detached():
            return None
        self._beat()
        try:
            while True:
                local = (self._fetch_version()
                         if self.step_count % self.poll_every == 0
                         else self._last_seen_version)
                self._last_seen_version = max(self._last_seen_version,
                                              local)
                agreed = self._agree(self._last_seen_version, "MAX")
                self._last_seen_version = max(self._last_seen_version,
                                              agreed)
                if agreed <= self.version:
                    break
                self._resize_to_server(agreed)
                if _flags.is_detached():
                    return None
                # fence again on the new membership before stepping: a
                # newcomer's first fence pairs with everyone's
            t0 = time.perf_counter()
            loss = super().step(global_batch)
            self._last_step_s = time.perf_counter() - t0
            measure = self._cadence_due()
            if self.collective_commit:
                self._commit_due(measure)
        except LOCAL_ERRORS:
            raise
        except PEER_ERRORS as e:
            if _flags.is_detached():
                raise
            return self._recover(global_batch, e)
        if not self.collective_commit:
            # a local commit: an error the committer kept is raised here
            self._commit_due(measure)
        return loss

    def _commit_due(self, measure: bool) -> None:
        if measure:
            self._measure_commit()
        elif self.step_count % self.snapshot_every == 0:
            self._commit()

    # ---------------------------------------------------------- recovery
    def _next_version(self, deadline: float):
        """Poll the config server until it holds a version newer than the
        membership's; ``(version, cluster)``, or None past ``deadline``."""
        while time.monotonic() < deadline:
            self._beat()
            try:
                version, cluster = fetch_config(self.config_server_url)
            except (OSError, ValueError, KeyError):
                version = -1      # unreachable for now: keep polling
            if version > self.version:
                return version, cluster
            time.sleep(_RECOVER_POLL_S)
        return None

    def _survivors_arrived(self, peers: PeerList, version: int,
                           deadline: float) -> bool:
        """Wait until every member of ``peers`` that this rank's group had
        (the survivors, as far as it knows) has reached version
        ``version``'s rendezvous.  False when a newer version appears
        first, or at ``deadline``: a member of this one is dead too.
        Only a FileStore rendezvous is watched this way."""
        if self.rendezvous is None:
            return True
        expect = sum(p in self.peers for p in peers)
        store = dist.FileStore(os.path.join(
            self.rendezvous, f"v{version}.survivors"), expect)
        store.add("arrived", 1)
        while store.add("arrived", 0) < expect:
            if time.monotonic() > deadline:
                return False
            try:
                if fetch_config(self.config_server_url)[0] > version:
                    return False
            except (OSError, ValueError, KeyError):
                pass              # unreachable for now: keep waiting
            self._beat()
            time.sleep(_RECOVER_POLL_S)
        return True

    def _rejoin(self, peers: PeerList, version: int, deadline: float):
        """Form the data group of ``peers`` at ``version`` (no consensus
        over the broken group) and agree on the version over it."""
        me = self.peers[self.rank]
        self.peers, self.n = peers, len(peers)
        self.rank = peers.rank(me)
        self.version = self.config_version = version
        self._last_seen_version = max(self._last_seen_version, version)
        _flags.set_cluster_version(version)
        D.initialize(peers, self.rank, version, self.rendezvous,
                     self.backend, self.collective_timeout_s,
                     max(1.0, deadline - time.monotonic()))
        self.session = Session(None, version)
        if self._agree(version, "MIN") != self._agree(version, "MAX"):
            raise RuntimeError(f"re-formed at version {version}, but the "
                               f"members disagree on it")

    def _committed_record(self):
        """The commit a recovery restores on this rank."""
        return self._committed

    def _restore_committed(self) -> int:
        """Restore the new rank 0's published commit, state and counters
        (step 6 of the module docstring).  Returns the bytes this rank
        sent or received."""
        host, devices, pair = self._committed_record()
        digest = tree_digest({k: v for k, v in host.items() if k != "sums"},
                             host["sums"])
        mine = torch.tensor([pair[0], pair[1], digest], dtype=torch.int64,
                            device=D.comm_device())
        every = C.all_gather(mine)
        differ = [r for r in range(1, self.n)
                  if not torch.equal(every[r], every[0])]
        moved, own = 0, True
        if differ:
            members = [0] + differ
            group = None if len(members) == self.n else dist.new_group(
                members)
            if self.rank in members:
                got = D.broadcast_tree(host if self.rank == 0 else None,
                                       group)
                moved = tree_nbytes(got)
                if self.rank != 0:
                    host, own = got, False
            if group is not None:
                dist.destroy_process_group(group)
        self._adopt(host["params"], host.get("model_state"))
        # this rank's own commit stays the recovery point (a later commit
        # reuses its buffers): every leaf is copied back where it lay.  A
        # received tree is fresh, and ``load_state_dict`` moves its
        # moments to this rank's parameters
        self._install(tree_map(
            lambda h, d: h.to(d, copy=True) if isinstance(
                h, torch.Tensor) else h, host["opt"], devices["opt"])
            if own else host["opt"])
        self.trained_samples, self.step_count = (int(every[0][0]),
                                                 int(every[0][1]))
        return moved

    def _recover(self, global_batch, cause: BaseException) -> Optional[float]:
        """A peer died or hung: leave the broken group, wait for the shrink,
        re-form, restore the last commit and redo the step (the module
        docstring's steps 1-7)."""
        t_error = time.time()
        # the traceback's frames hold the broken group: without them it
        # is freed at the abort, which closes its sockets
        traceback.clear_frames(cause.__traceback__)
        from_version, from_size, live_steps = self.version, self.n, \
            self.step_count
        D.abort()
        self._drain_quietly("recovery")
        deadline = time.monotonic() + self.recover_timeout
        me = self.peers[self.rank]
        while True:
            got = self._next_version(deadline)
            if got is None:
                # not a membership event after all: the original failure
                raise cause
            version, cluster = got
            t_version = time.time()
            if me not in cluster.workers:
                _flags.set_detached(True)
                self.version = version
                _flags.set_cluster_version(version)
                return None
            if not self._survivors_arrived(cluster.workers, version,
                                           deadline):
                self.version = version    # a member is gone: the next one
                continue
            try:
                self._rejoin(cluster.workers, version, deadline)
                break
            except PEER_ERRORS:
                # a member of that version is gone too: wait for the next
                D.abort()
        t_reformed = time.time()
        moved = self._restore_committed()
        rec = {"cause": f"{type(cause).__name__}: {cause}"[:300],
               "from_version": from_version, "from_size": from_size,
               "version": self.version, "size": self.n, "rank": self.rank,
               "restored": [self.trained_samples, self.step_count],
               "rewound": live_steps - self.step_count,
               "restore_bytes": moved, "t_error": t_error,
               "t_version": t_version, "t_reformed": t_reformed,
               "t_restored": time.time()}
        self.recoveries.append(rec)
        loss = self.step(global_batch)
        rec["t_step"] = time.time()
        return loss

    # ------------------------------------------------------------- other
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
        self._drain_quietly("shutdown")
        self._committer.close()
        if self._heartbeat is not None:
            self._heartbeat.stop()
        if not _flags.is_detached():
            super().shutdown()
