"""Elastic ZeRO-3 training whose membership changes at runtime, its state
re-sharded, not re-broadcast, at every change (counterpart of
kungfu_tpu/elastic/sharded.py).

:class:`~.multiproc.DistributedElasticTrainer` resizes a replicated job:
every rank holds the whole state, so a membership change is a broadcast.
Here the parameters and the optimizer state that mirrors them (Adam's
moments) live as flat vectors sharded 1/n a rank, the layout of
:func:`kungfu_tpu_torch.parallel.fsdp.make_fsdp_step` (one rank a device,
so JAX's ``ndev == nproc == n``), and no rank holds the whole: a change
moves to each member of the new membership the ranges of the old blocks
that its new chunk covers, from whichever member holds them.

Three events, three sources of the state:

- **a voluntary resize** (a config-server proposal): every member is alive
  at the fence.  The live state is committed, and each leaving rank's
  blocks go to its first surviving ring successor (:meth:`_pre_teardown`)
  before it leaves, so the survivors together hold every block.
- **a death** (a rank killed mid-step): its blocks die with it, so every
  commit also sends each rank's blocks to its ring successor, and any
  single death leaves every block on a survivor.  Two adjacent deaths at
  once lose a block, and the re-shard raises.
- **a grow**: a new rank holds nothing and receives its range from the
  survivors, with the committed counters.

A commit is consistent: it is recorded only after its replica exchange
has completed, every rank commits at the same step (one cadence, rank
0's), and a re-shard agrees on M, the newest commit every holder of a
commit has, which the 2-deep history keeps.  A voluntary resize first
commits the live state, so it rewinds nothing; a recovery rewinds to M.

Differences from the JAX trainer (ROADMAP Queue 3):

- No point-to-point store: the bytes move as host tensors over the gloo
  group itself, point to point (``isend``/``irecv``) in the one order
  every rank derives from the gathered plan, and only the range of an
  old block that a new chunk covers goes on the wire.  So the group is
  gloo (its ZeRO-3 collectives take CUDA tensors).
- No relay tree, no shared-memory lanes (the host plane is not ported).
- No chaos points, trace spans or ``monitor.net.Transfer``.
- The handoff's membership is the one ``_reform``'s consensus agreed on,
  so there is no rank-0 fetch and broadcast of the cluster.
- One rank a device.
- A fresh start scatters rank 0's initial vector a chunk a rank from the
  host, where JAX broadcasts the whole vector to every process.
- The commit's replica exchange runs on the main thread, at the join of
  the commit's host copy, over the training group (a gloo group takes
  one thread's collectives in one order on every rank); a commit is
  therefore synchronous, and a peer that dies in it is recovered from
  as from one that dies in the step (``collective_commit``).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import distributed as D
from ..comm.session import Session
from ..launcher import env as E
from ..parallel import fsdp as FS
from ..plan.peer import PeerList
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves, tree_map
from . import snapshot as SN
from .multiproc import DistributedElasticTrainer

class ShardedStateError(Exception):
    """The committed state cannot be re-formed on the new membership.
    Every member decides it from the same gathered headers and raises it
    together; it is not a peer's failure, so no recovery is attempted."""


def _layout(size: int, ndev: int, nproc: int) -> Tuple[int, int, int]:
    """(padded, per-device chunk, per-process block) of the flat vector
    on an ``ndev``-device, ``nproc``-process mesh; the padding is zeros
    and stays zero under an elementwise optimizer."""
    chunk = math.ceil(size / ndev)
    if ndev % nproc:
        raise ValueError(f"{ndev} devices do not split over {nproc} "
                         f"processes")
    return chunk * ndev, chunk, chunk * (ndev // nproc)


def agree_commit(headers: List[dict]) -> Tuple[int, dict]:
    """M, the newest commit every member holding a commit has, and its
    record (taken from the first such member).  Raises
    :class:`ShardedStateError` when a holder has lost M or the holders
    describe it differently."""
    holders = {j: h["slots"] for j, h in enumerate(headers) if h["slots"]}
    M = min(max(slots) for slots in holders.values())
    metas = set()
    for j, slots in holders.items():
        if M not in slots:
            raise ShardedStateError(
                f"sharded elastic: holder {j} lost commit {M} (has "
                f"{sorted(slots)}): commits drifted more than the 2-deep "
                f"history covers")
        s = slots[M]
        metas.add((s["samples"], s["steps"], s["n"], tuple(s["names"])))
    if len(metas) != 1:
        raise ShardedStateError(
            f"sharded elastic: holders disagree on commit {M}'s (samples, "
            f"steps, n, vectors): {sorted(metas)}; refusing to re-shard "
            f"from inconsistent history")
    return M, holders[min(holders)][M]


def plan_transfers(avail: List[List[bool]], old_block: int, size: int,
                   chunk: int) -> List[Tuple[int, int, int, int, int]]:
    """The moves of a re-shard: ``(src, dst, r, a, b)``, member ``src``
    sends member ``dst`` the canonical range ``[a, b)`` of old rank r's
    block, for every new rank ``dst`` (chunk ``chunk``) and every old
    block its range overlaps that it does not hold.  ``avail[j][r]``:
    member j holds old rank r's block (``old_block`` long).  The holders
    of a block share its pullers: ``src = js[(dst + r) % len(js)]``.
    Raises :class:`ShardedStateError` when a block is on no member."""
    old_n = len(avail[0]) if avail else 0
    holders = []
    for r in range(old_n):
        js = [j for j in range(len(avail)) if avail[j][r]]
        if not js:
            raise ShardedStateError(
                f"sharded elastic: old rank {r}'s state shard is on no "
                f"survivor (more simultaneous failures than the "
                f"single-failure ring replica covers)")
        holders.append(js)
    moves = []
    for dst in range(len(avail)):
        lo, hi = min(dst * chunk, size), min(size, (dst + 1) * chunk)
        for r in range(old_n):
            a, b = max(lo, r * old_block), min(hi, (r + 1) * old_block)
            if b > a and not avail[dst][r]:
                js = holders[r]
                moves.append((js[(dst + r) % len(js)], dst, r, a, b))
    return moves


def _exchange(sends, recvs) -> None:
    """Post every ``(tensor, peer, tag)`` send and receive, then wait for
    each once (a gloo work waited twice hangs)."""
    ops = [dist.P2POp(dist.isend, t, peer, tag=tag)
           for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, tag=tag)
            for t, peer, tag in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardedElasticTrainer(DistributedElasticTrainer):
    """Elastic ZeRO-3 training, one instance a rank, whose membership the
    config server changes at runtime; the state is re-sharded at every
    change (see the module docstring).

    The contract is :class:`~.multiproc.DistributedElasticTrainer`'s:
    ``step(global_batch)`` takes the global batch (every rank the same,
    its rows divisible by the cluster size), returns the mean loss, or
    None once this rank is detached.  ``loss_fn(params, batch)`` takes
    the whole parameter tree (gathered each step) and this rank's rows;
    ``optimizer_factory([shard], n)`` builds an elementwise optimizer
    (SGD, Adam, AdamW) over this rank's f32 chunk of the flat vector.
    ``init_params``: the tree's structure on every rank, and at a fresh
    start rank 0's values, which every rank starts from (other ranks'
    leaves may lie on the ``meta`` device).  ``device``: where the chunks
    and the step live (default ``cuda``).  The group is gloo: the moves
    are host tensors point to point, which NCCL does not take.

    Each event leaves a record in :attr:`reshards` (the commit M it
    re-sharded, the sizes, the bytes sent and received, the seconds of
    the plan and moves and of the build);
    :attr:`last_commit` and :attr:`last_handoff` hold the last commit's
    and hand-off's seconds and bytes (and the old blocks the hand-off
    brought this rank)."""

    collective_commit = True

    def __init__(self, loss_fn: Callable, optimizer_factory: Callable,
                 init_params, env: Optional[E.WorkerEnv] = None,
                 poll_every: int = 1, device=None, snapshot_every=1,
                 recover_timeout: float = 60.0,
                 collective_timeout_s: float = D.DEFAULT_TIMEOUT_S,
                 heartbeat_s: Optional[float] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._structure = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            init_params)
        self._vec_size = sum(t.numel() for t in tree_leaves(init_params))
        # seq -> {old rank: {vector name: padded host block}}, and seq ->
        # the commit's record; 2 deep
        self._held: Dict[int, Dict[int, Dict[str, torch.Tensor]]] = {}
        self._slots: Dict[int, dict] = {}
        self._spare = None        # host blocks of a dropped commit
        self._committed_progress = (0, 0)
        self._synced: Optional[dict] = None
        self._shard: Optional[torch.Tensor] = None
        self.reshards: List[dict] = []
        self.last_commit: Optional[dict] = None
        self.last_handoff: Optional[dict] = None
        super().__init__(loss_fn, optimizer_factory, init_params, env=env,
                         poll_every=poll_every, backend="gloo",
                         snapshot_every=snapshot_every,
                         recover_timeout=recover_timeout,
                         collective_timeout_s=collective_timeout_s,
                         heartbeat_s=heartbeat_s)

    # ---------------------------------------------------------- vectors
    def _vectors(self) -> Dict[str, torch.Tensor]:
        """The sharded vectors by name: "p", this rank's chunk of the
        parameters, and each optimizer entry that mirrors it
        (``fsdp._state_specs``), names sorted."""
        out = {"p": self._shard.detach()}
        spec = FS._state_specs(self.optimizer, {"p": self._shard})["p"]
        state = self.optimizer.state.get(self._shard, {})
        for k in sorted(state):
            if spec[k] == "shard":
                out[k] = state[k]
        return out

    def _small(self) -> dict:
        """The optimizer's replicated entries (Adam's step), copied."""
        spec = FS._state_specs(self.optimizer, {"p": self._shard})["p"]
        state = self.optimizer.state.get(self._shard, {})
        return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in state.items() if spec[k] == "replicated"}

    # ----------------------------------------------------------- commit
    def _commit(self, force: bool = False) -> None:
        """Commit the live state: this rank's blocks copied to pinned host
        memory, the predecessor's received (the ring replica), and only
        then recorded with the counters.  A collective; a no-op when the
        step is committed already, unless ``force``."""
        seq = self.step_count
        if seq in self._held and not force:
            return
        t0 = time.perf_counter()
        vecs = self._vectors()
        spare = self._spare or {}
        self._spare = None
        own = SN.dispatch(vecs, spare.get("own")).join()
        t_copy = time.perf_counter() - t0
        held = {self.rank: own}
        moved = 0
        if self.n > 1:
            pred = (self.rank - 1) % self.n
            got = spare.get("pred")
            if got is None or [(k, v.shape, v.dtype) for k, v in
                               got.items()] != [(k, v.shape, v.dtype)
                                                for k, v in own.items()]:
                got = {k: torch.empty_like(v) for k, v in own.items()}
            names = sorted(own)
            _exchange([(own[k], (self.rank + 1) % self.n, i)
                       for i, k in enumerate(names)],
                      [(got[k], pred, i) for i, k in enumerate(names)])
            held[pred] = got
            moved = sum(_nbytes(v) for v in own.values())
        # recorded only now: a commit whose exchange a peer's death cut
        # leaves the previous one as the recovery point
        self._held[seq] = held
        self._slots[seq] = {
            "samples": self.trained_samples, "steps": self.step_count,
            "n": self.n, "rank": self.rank, "names": sorted(vecs),
            "dtypes": {k: v.dtype for k, v in vecs.items()},
            "small": self._small()}
        for old in sorted(self._held)[:-2]:
            dropped, slot = self._held.pop(old), self._slots.pop(old)
            r, n = slot["rank"], slot["n"]
            self._spare = {"own": dropped.get(r),
                           "pred": dropped.get((r - 1) % n) if n > 1
                           else None}
        self._committed_progress = (self.trained_samples, self.step_count)
        self.last_commit = {"seq": seq, "n": self.n,
                            "seconds": time.perf_counter() - t0,
                            "copy_seconds": t_copy, "sent_bytes": moved,
                            "received_bytes": moved}

    @property
    def committed_progress(self):
        """``(trained_samples, step_count)`` of the last recorded commit."""
        return self._committed_progress

    # ------------------------------------------------- voluntary handoff
    def _pre_teardown(self, old_peers: PeerList, new_peers: PeerList
                      ) -> None:
        """Commit the live state, then hand each leaving rank's blocks to
        its first surviving ring successor, over the old group (the
        successor right after it holds them already, as its replica)."""
        n = len(old_peers)
        alive = [i for i, p in enumerate(old_peers) if p in new_peers]
        departing = [i for i in range(n) if i not in alive]
        if departing and not alive:
            raise ShardedStateError("sharded elastic: resize replaces every "
                                    "member; no survivor can carry the "
                                    "state")
        t0 = time.perf_counter()
        self._commit()
        seq = max(self._held)
        mine = self._held[seq][self.rank]
        names = sorted(mine)
        sends, recvs, got = [], [], {}
        for r in departing:
            succ = next((r + k) % n for k in range(1, n)
                        if (r + k) % n in alive)
            if (succ - 1) % n == r:
                continue
            tags = [r * len(names) + i for i in range(len(names))]
            if self.rank == succ:
                got[r] = {k: torch.empty_like(mine[k]) for k in names}
                recvs += [(got[r][k], r, t) for k, t in zip(names, tags)]
            elif self.rank == r:
                sends += [(mine[k], succ, t) for k, t in zip(names, tags)]
        _exchange(sends, recvs)
        self._held[seq].update(got)
        self.last_handoff = {
            "seconds": time.perf_counter() - t0, "blocks": sorted(got),
            "sent_bytes": sum(_nbytes(t) for t, _, _ in sends),
            "received_bytes": sum(_nbytes(t) for t, _, _ in recvs)}

    # ---------------------------------------------------------- re-shard
    def _header(self) -> dict:
        return {"slots": self._slots,
                "blocks": {s: sorted(h) for s, h in self._held.items()},
                "committed": self._committed_progress,
                "cadence": (self.snapshot_every, self._auto_snap),
                "config_version": self.config_version}

    def _sync_state(self, newcomers=None) -> None:
        """Re-shard the committed state onto the live membership (every
        member calls it, at a resize, a recovery or the constructor):
        agree on M, plan the moves from the gathered headers, send and
        receive them, and adopt M's counters and rank 0's cadence.
        ``_build`` then makes the chunks from what was received."""
        t0 = time.perf_counter()
        hdrs = [None] * self.n
        dist.all_gather_object(hdrs, self._header())
        n, me = self.n, self.rank
        _, chunk, _ = _layout(self._vec_size, n, n)
        lo = min(me * chunk, self._vec_size)
        hi = min(self._vec_size, (me + 1) * chunk)
        sent = received = 0
        if not any(h["slots"] for h in hdrs):
            done = max(h["committed"][1] for h in hdrs)
            if done > 0:
                raise ShardedStateError(
                    f"sharded elastic: committed progress (step {done}) "
                    f"exists but no member holds a commit; refusing to "
                    f"fresh-start over trained state")
            block, sent = self._fresh_block()
            received = 0 if me == 0 else _nbytes(block)
            M, old_n, old_block = None, n, chunk
            record = {"samples": 0, "steps": 0, "names": ["p"],
                      "dtypes": {"p": torch.float32}, "small": {}}
            pulled = {"p": {me: block}}
        else:
            M, record = agree_commit(hdrs)
            for s in [s for s in self._held if s > M]:
                # the steps after M are redone: a commit of theirs (one a
                # peer's death cut on other ranks) is not the one those
                # steps will make, and a commit at its step would be
                # skipped on this rank alone
                del self._held[s], self._slots[s]
            old_n = record["n"]
            _, _, old_block = _layout(self._vec_size, old_n, old_n)
            avail = [[r in h["blocks"].get(M, ()) for r in range(old_n)]
                     for h in hdrs]
            moves = plan_transfers(avail, old_block, self._vec_size, chunk)
            names = record["names"]
            held = self._held.get(M, {})
            pulled = {k: {r: b[k] for r, b in held.items()} for k in names}
            sends, recvs = [], []
            for i, (src, dst, r, a, b) in enumerate(moves):
                s, e = a - r * old_block, b - r * old_block
                for j, k in enumerate(names):
                    tag = i * len(names) + j
                    if src == me:
                        sends.append((held[r][k][s:e], dst, tag))
                    elif dst == me:
                        if r not in pulled[k]:
                            pulled[k][r] = torch.empty(
                                old_block, dtype=record["dtypes"][k])
                        recvs.append((pulled[k][r][s:e], src, tag))
            _exchange(sends, recvs)
            sent = sum(_nbytes(t) for t, _, _ in sends)
            received = sum(_nbytes(t) for t, _, _ in recvs)
        self._synced = {"M": M, "names": record["names"],
                        "dtypes": record["dtypes"], "small": record["small"],
                        "pulled": pulled, "old_block": old_block,
                        "lo": lo, "hi": hi}
        self.trained_samples = record["samples"]
        self.step_count = record["steps"]
        self._committed_progress = (self.trained_samples, self.step_count)
        self.snapshot_every, self._auto_snap = hdrs[0]["cadence"]
        self.config_version = hdrs[0]["config_version"]
        self.params = None      # the caller's tree is not kept
        self.last_sync_bytes = sent + received
        self.reshards.append({
            "version": self.version, "M": M, "from_n": old_n, "to_n": n,
            "rank": me, "sent_bytes": sent, "received_bytes": received,
            "seconds": time.perf_counter() - t0})

    def _fresh_block(self) -> Tuple[torch.Tensor, int]:
        """A fresh start: this rank's chunk of rank 0's initial vector,
        scattered from rank 0's host; the bytes rank 0 sent."""
        n, me = self.n, self.rank
        _, chunk, _ = _layout(self._vec_size, n, n)
        parts = None
        if me == 0:
            leaves = tree_leaves(self.params)
            if any(t.is_meta for t in leaves):
                raise ValueError("rank 0 of a fresh start gives the initial "
                                 "values: its init_params lie on the meta "
                                 "device")
            flat = torch.zeros(chunk * n)
            flat[:self._vec_size] = torch.cat(
                [t.detach().reshape(-1).float().cpu() for t in leaves])
            parts = list(flat.split(chunk))
        if n == 1:
            return parts[0], 0
        out = torch.empty(chunk)
        dist.scatter(out, parts, src=0)
        return out, (n - 1) * chunk * 4 if me == 0 else 0

    def _assemble(self, name: str, lo: int, hi: int, old_block: int,
                  pulled: Dict[int, torch.Tensor], dtype,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Canonical ``[lo, hi)`` of vector ``name`` from old-layout blocks
        (zero past the unpadded size, the padding).  ``out``: a zeroed
        tensor of ``hi - lo`` elements, on any device, to write it into."""
        if out is None:
            out = torch.zeros(hi - lo, dtype=dtype)
        for r, block in pulled.items():
            blo = r * old_block
            s = max(lo, blo)
            e = min(hi, blo + block.shape[0], self._vec_size)
            if e > s:
                out[s - lo:e - lo].copy_(block[s - blo:e - blo])
        return out

    # ------------------------------------------------------------- build
    def _build(self) -> None:
        """This rank's chunks on the device from what ``_sync_state``
        received, the optimizer over them (its moments and step adopted
        when M had them) and the ZeRO-3 step of the new group."""
        t0 = time.perf_counter()
        sy, self._synced = self._synced, None
        self.optimizer = self._shard = None       # the old state goes first
        meta = FS.flat_meta(self._structure)
        vecs = {}
        for k in sy["names"]:
            vecs[k] = torch.zeros(meta.local, dtype=sy["dtypes"][k],
                                  device=self.device)
            self._assemble(k, sy["lo"], sy["hi"], sy["old_block"],
                           sy["pulled"][k], sy["dtypes"][k],
                           out=vecs[k][:sy["hi"] - sy["lo"]])
        self._shard = vecs.pop("p").requires_grad_()
        self.optimizer = self.optimizer_factory([self._shard], self.n)
        if vecs:
            self.optimizer.state[self._shard] = {
                **vecs, **{k: (v.clone() if isinstance(v, torch.Tensor)
                               else v) for k, v in sy["small"].items()}}
        self._meta = meta
        self._step = FS.make_fsdp_step(self.loss_fn, None)[1](meta)
        self.reshards[-1]["build_seconds"] = time.perf_counter() - t0

    def _carried_state(self) -> None:
        """Nothing: the re-shard brings the state, and the old moments
        must not stay alive through the build."""
        return None

    def _install(self, opt_state=None) -> None:
        """Build on the live group and commit at once, so the membership
        has a commit with its ring replica before its first step (the
        previous history stays until that commit is recorded)."""
        self.session = Session(None, self.version)
        self._build()
        self._commit(force=True)

    def _restore_committed(self) -> int:
        """A recovery's restore: re-shard M onto the survivors."""
        self._sync_state(None)
        self._install()
        return self.last_sync_bytes

    def _train(self, global_batch) -> torch.Tensor:
        return self._step(self._shard, self.optimizer, global_batch)

    # ------------------------------------------------------------ public
    def current_params(self):
        """The whole parameter tree, unpadded, on the host (a collective:
        every member calls it together)."""
        full = FS.fsdp_all_gather_params(self._shard.detach())
        return self._meta.unravel(full[:self._vec_size].cpu())

    def local_state_bytes(self) -> int:
        """The newest commit's bytes on this rank: its own blocks and the
        ring replica (about 2/n of the state)."""
        if not self._held:
            return 0
        return sum(_nbytes(b) for blocks in self._held[max(self._held)]
                   .values() for b in blocks.values())

    def num_devices(self) -> int:
        return self.n

    def save_checkpoint(self, ckpt, force: bool = False) -> bool:
        raise NotImplementedError(
            "ShardedElasticTrainer keeps no checkpoint; see "
            "parallel.fsdp.fsdp_state_dict")

    def restore_checkpoint(self, ckpt, step=None) -> int:
        raise NotImplementedError(
            "ShardedElasticTrainer keeps no checkpoint; see "
            "parallel.fsdp.load_fsdp_state_dict")
