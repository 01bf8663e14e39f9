"""Elastic training: the cluster resized at runtime, state re-synchronised
(counterpart of kungfu_tpu/elastic/trainer.py).

Reference protocol: a membership change is fenced by a consensus round;
every member rebuilds its session at a bumped version; removed peers see
``detached`` and stop; the others sync progress (an all-reduce MAX of the
trained samples) and rank 0 broadcasts the model state to the newcomers.

Where the JAX trainer is one controller whose "cluster" is a set of mesh
lanes, here each member is a process holding one replica (a rank of the
data group, the mapping ``kungfu_tpu_torch.training`` uses), and
:class:`ElasticTrainer` runs in every one of them.  A resize:

1. ``bytes_consensus`` on the proposal, over the old group;
2. the version goes up;
3. members left out of the new membership set ``detached`` and leave;
4. survivors and newcomers join the data group at the new version, a
   rendezvous of its own (:mod:`kungfu_tpu_torch.distributed`);
5. rank 0 sends the newcomers its parameters, model state and optimizer
   state, structure first (a newcomer's ``torch.optim`` optimizer has no
   state until its first step, so there is nothing to receive into), then
   the tensors; survivors keep their replica where it lies, since a
   ``torch.distributed`` teardown, unlike JAX's, invalidates no tensor;
6. ``sync_progress``: an exact int64 all-reduce MAX of the trained samples;
7. the optimizer is rebuilt by ``optimizer_factory`` on the new group (a
   wrapper such as ``synchronous_sgd`` binds its group when built, and the
   old group is gone), carrying the old one's ``state_dict()``.

New processes join by constructing the trainer at the new version: the
constructor runs step 4 onward, and at a fresh start (every member at
once) rank 0's state goes to all, as the JAX trainers start every lane
from one replica.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import distributed as D
from .. import training as T
from ..comm.session import Session
from ..plan.peer import PeerList
from ..utils.tree import tree_leaves
from . import state as _flags
from .config_server import fetch_config
from .snapshot import snapshot, tree_nbytes


class ElasticTrainer:
    """Elastic synchronous training, one instance per rank.

    ``loss_fn(params, batch) -> loss`` (or, with ``init_model_state``,
    ``loss_fn(params, model_state, batch) -> (loss, new_model_state)``, as
    ``training.build_train_step_with_state`` takes it).
    ``optimizer_factory(leaves, n) -> torch.optim.Optimizer`` builds the
    optimizer over the float leaves of ``init_params`` for an ``n``-rank
    cluster (pair averaging needs the rank count) on the live default
    group.  ``init_params`` is this rank's parameter tree (the f32
    masters), trained in place.

    ``peers`` lists every rank the cluster may hold; the first
    ``init_size`` (default: all) are the members, and this process is
    ``rank`` among them.  ``version`` is the cluster version to join: 0
    for a fresh job, the resize's new version for a newcomer.
    ``rendezvous`` (a directory) and ``backend`` as in
    :func:`kungfu_tpu_torch.distributed.initialize`, whose ``timeout_s``
    is ``collective_timeout_s``: a collective stuck on a peer that hangs
    raises after it.  ``compute_dtype`` as
    in ``build_train_step``; ``microbatch`` splits each rank's block into
    microbatches of that many rows (gradients accumulated), whatever the
    block's size at the current cluster size.
    """

    def __init__(self, loss_fn: Callable, optimizer_factory: Callable,
                 init_params, peers: Sequence, rank: int,
                 init_size: Optional[int] = None, version: int = 0,
                 rendezvous: Optional[str] = None,
                 backend: Optional[str] = None,
                 config_server_url: Optional[str] = None,
                 max_size: Optional[int] = None, init_model_state=None,
                 compute_dtype: Optional[torch.dtype] = None,
                 microbatch: Optional[int] = None,
                 collective_timeout_s: float = D.DEFAULT_TIMEOUT_S):
        self.loss_fn = loss_fn
        self.optimizer_factory = optimizer_factory
        self.config_server_url = config_server_url
        self.capacity = PeerList(peers)
        self.max_size = max_size or len(self.capacity)
        self.n = init_size or len(self.capacity)
        self.peers = self.capacity[:self.n]
        self.rank = rank
        self.version = version
        self.rendezvous = rendezvous
        self.backend = backend
        self.compute_dtype = compute_dtype
        self.microbatch = microbatch
        self.collective_timeout_s = collective_timeout_s
        self.config_version = -1
        self.trained_samples = 0
        self.step_count = 0
        self.last_resize_seconds: Optional[float] = None
        # bytes of state this rank sent (rank 0) or received (a newcomer)
        # at the last re-sync
        self.last_sync_bytes = 0
        self.params = init_params
        self.has_model_state = init_model_state is not None
        self.model_state = init_model_state
        self.optimizer: Optional[torch.optim.Optimizer] = None
        _flags.set_detached(False)
        _flags.set_cluster_version(version)
        D.initialize(self.peers, rank, version, rendezvous, backend,
                     collective_timeout_s)
        self.session = Session(None, version)
        self._install(self._sync_state(None))

    # ---------------------------------------------------------------- core
    def _leaves(self) -> List[torch.Tensor]:
        return [t for t in tree_leaves(self.params) if t.is_floating_point()]

    def _install(self, opt_state: Optional[dict]) -> None:
        """Build the optimizer and the steps on the live group, loading
        ``opt_state`` (a ``state_dict()``) when given."""
        self.session = Session(None, self.version)
        self.optimizer = self.optimizer_factory(self._leaves(), self.n)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        self._steps: Dict[int, Callable] = {}

    def _step_for(self, accum: int) -> Callable:
        if accum not in self._steps:
            if self.has_model_state:
                self._steps[accum] = T.build_train_step_with_state(
                    self.loss_fn, self.optimizer, self.params,
                    self.model_state, accum_steps=accum,
                    compute_dtype=self.compute_dtype)
            else:
                self._steps[accum] = T.build_train_step(
                    self.loss_fn, self.optimizer, self.params,
                    accum_steps=accum, compute_dtype=self.compute_dtype)
        return self._steps[accum]

    def step(self, global_batch) -> float:
        """One synchronous step on the global batch (every rank passes the
        same); this rank trains its contiguous block of it.  Returns the
        mean loss over the cluster."""
        loss = self._train(global_batch)
        self.step_count += 1
        self.trained_samples += int(tree_leaves(global_batch)[0].shape[0])
        return float(loss)

    def _train(self, global_batch) -> torch.Tensor:
        """The update of one step on this rank's block; the mean loss."""
        local = T._local_slice(global_batch, self.rank, self.n)
        rows = tree_leaves(local)[0].shape[0]
        accum = 1
        if self.microbatch is not None:
            if rows % self.microbatch:
                raise ValueError(f"a rank's {rows} rows do not split into "
                                 f"microbatches of {self.microbatch}")
            accum = rows // self.microbatch
        return self._step_for(accum)(local, local=True)

    # --------------------------------------------------------------- resize
    def resize(self, new_size: int) -> bool:
        """Apply a new cluster size (collective over the current members);
        True when the membership changed.  Growing needs the newcomers to
        construct their trainers at version ``self.version + 1``."""
        if new_size == self.n:
            return False
        if new_size > self.max_size:
            raise ValueError(f"size {new_size} exceeds capacity "
                             f"{self.max_size}")
        if new_size <= 0:
            _flags.set_detached(True)
            return True
        return self._reform(self.capacity[:new_size], self.version + 1)

    def _reform(self, new_peers: PeerList, new_version: int) -> bool:
        """Move to membership ``new_peers`` at ``new_version`` (the resize
        sequence of the module docstring).  Returns True."""
        proposal = f"{new_version}|{new_peers.to_string()}".encode()
        if not self.session.bytes_consensus(proposal):
            raise RuntimeError("resize proposal diverged across peers")
        t0 = time.perf_counter()
        me, old_peers = self.peers[self.rank], self.peers
        self.version = new_version
        _flags.set_cluster_version(new_version)
        if new_peers == old_peers:
            self.session = Session(None, new_version)
            return True
        self._pre_teardown(old_peers, new_peers)
        if me not in new_peers:
            D.shutdown()
            self._steps = {}
            _flags.set_detached(True)
            self.last_resize_seconds = time.perf_counter() - t0
            return True
        carried = self._carried_state()
        self.peers, self.n = new_peers, len(new_peers)
        self.rank = new_peers.rank(me)
        D.reinit(new_peers, self.rank, new_version, self.rendezvous,
                 self.backend, self.collective_timeout_s)
        newcomers = [r for r, p in enumerate(new_peers)
                     if p not in old_peers]
        got = self._sync_state(newcomers)
        self._install(carried if got is None else got)
        self.last_resize_seconds = time.perf_counter() - t0
        return True

    def _carried_state(self) -> Optional[dict]:
        """What a survivor's rebuilt optimizer loads: its own state."""
        return self.optimizer.state_dict()

    def _pre_teardown(self, old_peers: PeerList, new_peers: PeerList
                      ) -> None:
        """Runs over the old group, every member alive, once the proposal
        is agreed and before a leaving rank goes: a replica holds all it
        needs, so nothing here (the sharded trainer hands the leaving
        ranks' state to survivors)."""

    def _sync_state(self, newcomers: Optional[List[int]]) -> Optional[dict]:
        """Rank 0 sends its state to ``newcomers`` (ranks of the live
        group; None on rank 0 means all others: a fresh start or a
        restore).  Every rank calls it; rank 0 decides, the others learn
        what it decided.  Returns the optimizer state a receiver got, else
        None."""
        fresh = newcomers is None
        meta = [None]
        if self.rank == 0:
            meta[0] = {
                "newcomers": (list(range(1, self.n)) if fresh
                              else newcomers),
                "fresh": fresh, "progress": self._progress_meta()}
        dist.broadcast_object_list(meta, src=0)
        meta = meta[0]
        if meta["fresh"] and not fresh:
            raise RuntimeError("the new rank 0 holds no state to send: a "
                               "newcomer took rank 0")
        receivers = meta["newcomers"]
        got = None
        self.last_sync_bytes = 0
        if receivers:
            members = [0] + receivers
            group = None if len(members) == self.n else dist.new_group(
                members)
            if self.rank in members:
                got = self._broadcast_state(group)
                if group is not None:
                    dist.destroy_process_group(group)
        if self.rank in receivers:
            self._adopt_progress(meta["progress"])
        self.sync_progress()
        return got

    def _progress_meta(self) -> dict:
        """What a receiver of rank 0's state adopts besides the tensors."""
        return {"step_count": self.step_count,
                "trained_samples": self.trained_samples,
                "config_version": self.config_version}

    def _adopt_progress(self, meta: dict) -> None:
        self.step_count = meta["step_count"]
        self.trained_samples = meta["trained_samples"]
        self.config_version = meta["config_version"]

    def _broadcast_state(self, group) -> Optional[dict]:
        """Rank 0's params, model state and optimizer state over ``group``
        (rank 0 and the receivers); a receiver copies them into its own
        tensors and returns the optimizer state to load."""
        state = None
        if self.rank == 0:
            state = {"params": self.params,
                     "opt": (self.optimizer.state_dict()
                             if self.optimizer is not None else None)}
            if self.has_model_state:
                state["model_state"] = self.model_state
        got = D.broadcast_tree(state, group)
        self.last_sync_bytes = tree_nbytes(got)
        if self.rank == 0:
            return None
        self._adopt(got["params"], got.get("model_state"))
        return got["opt"]

    def _adopt(self, params, model_state) -> None:
        """Copy ``params`` (and ``model_state``) into this rank's tensors."""
        pairs = [(self.params, params)]
        if self.has_model_state:
            pairs.append((self.model_state, model_state))
        with torch.no_grad():
            for mine, theirs in pairs:
                for t, v in zip(tree_leaves(mine), tree_leaves(theirs)):
                    t.copy_(v)

    def resize_from_url(self, timeout: float = 30.0) -> Tuple[bool, bool]:
        """Poll the config server and apply its cluster size; returns
        ``(changed, detached)``."""
        if not self.config_server_url:
            raise ValueError("no config server configured")
        version, cluster = fetch_config(self.config_server_url,
                                        deadline=timeout,
                                        retry_unseeded=True)
        if version == self.config_version:
            return False, False
        self.config_version = version
        n = cluster.size()
        changed = self.resize(n if self.max_size is None
                              else min(n, self.max_size))
        return changed, _flags.is_detached()

    # ----------------------------------------------------------- state sync
    def _agree(self, v: int, op: str) -> int:
        """``v`` reduced over the group by ``op``, exact in int64."""
        x = torch.tensor([v], dtype=torch.int64, device=D.comm_device())
        return int(self.session.all_reduce(x, op)[0])

    def sync_progress(self) -> int:
        """All-reduce MAX of the trained samples, exact in int64."""
        self.trained_samples = self._agree(self.trained_samples, "MAX")
        return self.trained_samples

    def current_params(self):
        """This rank's parameters, copied to the host."""
        return snapshot(self.params)

    def current_model_state(self):
        """This rank's model state (BatchNorm statistics), on the host."""
        if not self.has_model_state:
            raise ValueError("trainer was built without model state")
        return snapshot(self.model_state)

    # ---------------------------------------------------------- checkpoints
    def save_checkpoint(self, ckpt, force: bool = False) -> bool:
        """Write the parameters, optimizer state and model state with the
        progress counters (rank 0 writes; see ``Checkpointer.save``)."""
        state = {"model": self.params, "opt": self.optimizer.state_dict()}
        if self.has_model_state:
            state["mstate"] = self.model_state
        meta = {"trained_samples": self.trained_samples,
                "step_count": self.step_count, "size": self.n}
        return ckpt.save(self.step_count, state, meta=meta, force=force)

    def restore_checkpoint(self, ckpt, step: Optional[int] = None) -> int:
        """Resume from disk at the current cluster size, whatever the size
        at save time (collective): rank 0 reads the checkpoint and sends
        the state and counters to every other rank.  Returns the step
        (``save_checkpoint`` writes the step count as the step)."""
        if self.rank == 0:
            _, state, meta = ckpt.restore(step=step)
            self._adopt(state["model"], state.get("mstate"))
            self.optimizer.load_state_dict(state["opt"])
            self.trained_samples = int(meta["trained_samples"])
            self.step_count = int(meta["step_count"])
        opt_state = self._sync_state(None)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        return self.step_count

    def shutdown(self) -> None:
        """Ordered end-of-job teardown of the data group (every member
        calls it; a detached rank has left already)."""
        D.shutdown_ordered()
