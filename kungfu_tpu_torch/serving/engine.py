"""Continuous-batching decode engine over the paged KV cache
(counterpart of kungfu_tpu/serving/engine.py).

* a fixed set of **slots** (the decode batch dimension);
* per-slot positions, the paged block tables and the sampling settings
  live on the host and ride into each step as ordinary arguments, so
  requests joining, leaving or being preempted change no shapes;
* **bucketed dense prefill** for a group of requests that share a prompt
  bucket: one causal forward over the right-padded prompts writes K/V
  for every position at once (padding is exact under causal masking);
* **on-demand block allocation**: a slot holds only the blocks its tokens
  fill.  When the pool runs dry the youngest slot is preempted back to
  the queue and replayed later, token for token;
* **chunked decode**: ``decode_chunk`` steps run back to back with the
  sampled tokens kept on the device; the host syncs once per chunk;
* **speculative verify** (``speculative=K``): prompt-lookup drafts, and
  one verify pass checks the current token plus up to K drafts.

The per-request oracle is ``models.gpt.generate``: greedy requests get
exactly the tokens the plain decoder produces.

Left for later slices of the port: tensor-parallel serving, int8
weights, the prefix cache, and the observability hooks (request journal,
trace events, monitor gauges, chaos points).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import gpt as G
from ..models.gpt import GPTConfig
from ..utils.device import resolve_device
from .cache import (init_paged_pools, lookup_blocks, pool_attend,
                    pool_attend_queries, pool_write_at,
                    pool_write_prompt_batch, pool_write_token)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int
    eos: Optional[int] = None
    # 0.0 = greedy; > 0 samples with a per-request key discipline: the
    # draw for token t depends only on (uid, t), so a sampled request's
    # tokens are the same whatever slot it lands in, whatever else is in
    # flight, and across preemption replays
    temperature: float = 0.0
    # top_k > 0: sample only among the k highest logits (ties at the
    # k-th kept); top_p < 1: nucleus sampling.  Ignored when greedy.
    top_k: int = 0
    top_p: float = 1.0


@dataclasses.dataclass
class _Running:
    req: Request
    slot: int
    blocks: List[int]            # pool blocks owned, in logical order
    out: List[int]               # generated tokens so far
    # speculative drafting: incremental bigram -> most recent strictly
    # earlier position of its second token (O(1) per emitted token)
    ngrams: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    indexed_to: int = 0          # history prefix length already indexed

    def history(self) -> List[int]:
        return list(self.req.prompt) + self.out

    def index_history(self) -> None:
        """Advance the bigram index to cover history[:-1] (the tail
        bigram stays unindexed until the next token arrives)."""
        h = self.history()
        start = max(self.indexed_to, 2)
        for i in range(start, len(h)):
            self.ngrams[(h[i - 2], h[i - 1])] = i - 1
        self.indexed_to = max(self.indexed_to, len(h))

    def draft(self, K: int) -> List[int]:
        """Prompt-lookup draft via the incremental index; equivalent to
        _propose_draft(history, K)."""
        h = self.history()
        if len(h) < 3 or K <= 0:
            return []
        self.index_history()
        p = self.ngrams.get((h[-2], h[-1]))
        if p is None:
            return []
        return h[p + 1:p + 1 + K]


class EngineStats:
    def __init__(self, slots: int = 0):
        self._slots = slots
        self.reset()

    def reset(self):
        """Zero the counters; keeps the slot count occupancy divides by."""
        self.decode_steps = 0        # position budget (K or Q per go)
        self.dispatches = 0          # decode passes launched
        self.slot_steps = 0          # sum over steps of active slots
        self.tokens_out = 0          # tokens delivered (preempted work
        self.prefills = 0            # is subtracted when discarded)
        self.preemptions = 0
        self.spec_proposed = 0       # speculative: drafted tokens sent
        self.spec_accepted = 0       # ...and verified == model argmax
        self.wall_s = 0.0

    @property
    def occupancy(self):
        tot = self.decode_steps * self._slots if self.decode_steps else 0
        return self.slot_steps / tot if tot else 0.0

    def summary(self):
        out = {"tokens_out": self.tokens_out,
               "decode_steps": self.decode_steps,
               "dispatches": self.dispatches,
               "prefills": self.prefills,
               "preemptions": self.preemptions,
               "occupancy": round(self.occupancy, 3),
               "wall_s": round(self.wall_s, 3),
               "tok_per_s": round(self.tokens_out / self.wall_s, 1)
               if self.wall_s else 0.0}
        if self.spec_proposed:
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
            out["spec_accept_rate"] = round(
                self.spec_accepted / self.spec_proposed, 3)
        return out


def _decode_core(params, cfg: GPTConfig, block_size: int, pools, tables,
                 pos, tokens, attend_mode: str = "auto"):
    """One decode step for every slot: feed each its last token at its
    own position, write K/V through the block tables (inactive slots'
    zeroed rows route to scratch), attend straight off the pool, return
    f32 logits [S, V]."""
    x = G.embed(params, tokens[:, None], pos[:, None], cfg)
    blk, off = lookup_blocks(tables, pos, block_size)
    for layer, pool in zip(params["layers"], pools):
        q, kk, v = G._layer_qkv(layer, x, cfg, pos=pos[:, None])
        pool_write_token(pool, blk, off, kk[:, 0], v[:, 0])
        o = pool_attend(q, pool, tables, pos, mode=attend_mode)
        x = G._layer_finish(layer, x, o, cfg)
    x = G.rms_norm(x, params["lnf"])
    return G._head(params, x)


def _filter_logits(lg, k: int, p: float):
    """Top-k / top-p (nucleus) filter for one logits row [V] (f32):
    tokens outside the filter go to -inf.  ``k <= 0`` and ``p >= 1``
    disable their halves.  Ties at the k-th logit are all kept; top-p
    keeps the smallest descending-probability prefix whose cumulative
    mass reaches p (always at least the argmax).  Stays on the device."""
    V = lg.shape[-1]
    srt = torch.sort(lg, descending=True).values
    kk = min(max(V if k <= 0 else k, 1), V)
    kth = srt[kk - 1]
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs       # exclusive prefix mass
    n_keep = (cum < p).sum()                        # >= 1 for p > 0
    pth = srt[torch.clamp(n_keep - 1, min=0)]
    return torch.where(lg >= torch.maximum(kth, pth), lg,
                       torch.full_like(lg, -float("inf")))


def _sample_seed(uid_lo: int, uid_hi: int, t: int) -> int:
    """The draw's seed: a function of (uid halves, token index) only."""
    h = hashlib.blake2b(np.asarray([uid_lo, uid_hi, t],
                                   np.uint64).tobytes(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def _pick_tokens(logits, uid_lo, uid_hi, tcount, temp, top_k, top_p):
    """Greedy or per-slot sampled next token, int32 [S] on the device.
    ``logits`` [S, V] on the device; the per-slot settings are host
    arrays [S].  A sampled slot draws Gumbel-max noise from a generator
    seeded by (uid, token index) alone, after the top-k/top-p filter, so
    its stream does not depend on scheduling (JAX's fold_in/categorical
    bits are not reproduced; the discipline is)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = np.nonzero(np.asarray(temp) > 0)[0]
    if not len(sampled):
        return greedy
    out = greedy.clone()
    for s in sampled:
        lg = _filter_logits(logits[s].float(), int(top_k[s]),
                            float(top_p[s]))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_sample_seed(int(uid_lo[s]), int(uid_hi[s]),
                                     int(tcount[s])))
        u = torch.rand(lg.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        out[s] = torch.argmax(lg / max(float(temp[s]), 1e-6)
                              + gumbel).to(torch.int32)
    return out


def _make_decode_chunk(cfg: GPTConfig, block_size: int, chunk: int,
                       attend_mode: str = "auto"):
    """``chunk`` decode steps back to back, each feeding its sampled
    tokens to the next on the device; returns all sampled tokens
    [chunk, S] on the device, so the caller syncs once per chunk (the
    reason the JAX engine runs the chunk as one lax.scan program).  A
    finished sequence's trailing in-chunk steps sample discarded tokens,
    written to the slot's own blocks or scratch."""

    @torch.no_grad()
    def run(params, pools, tables, pos, tokens, uid_lo, uid_hi, tcount,
            temp, top_k, top_p):
        toks = []
        tok = tokens
        for i in range(chunk):
            logits = _decode_core(params, cfg, block_size, pools, tables,
                                  pos + i, tok, attend_mode)
            tok = _pick_tokens(logits, uid_lo, uid_hi, tcount + i, temp,
                               top_k, top_p)
            toks.append(tok)
        return torch.stack(toks)                     # [chunk, S]

    return run


def _make_verify(cfg: GPTConfig, block_size: int, K: int,
                 attend_mode: str = "auto"):
    """Speculative-decoding verify: feed every slot its current token plus
    ``K`` drafted continuations (Q = K+1 positions) in one forward and
    return the model's prediction at each position [S, Q].  Greedy
    speculative decoding is lossless: the emitted stream equals the
    sequential argmax stream whatever the drafts.  Rejected positions
    leave stale K/V that no later query reads before it is rewritten."""
    Q = K + 1

    @torch.no_grad()
    def verify(params, pools, tables, pos, draft, uid_lo, uid_hi, tcount,
               temp, top_k, top_p):
        qpos = pos[:, None] + torch.arange(Q, device=pos.device,
                                           dtype=pos.dtype)[None, :]
        x = G.embed(params, draft, qpos, cfg)                # [S, Q, D]
        for layer, pool in zip(params["layers"], pools):
            q, kk, v = G._layer_qkv(layer, x, cfg, pos=qpos)
            pool_write_at(pool, tables, qpos, kk, v, block_size)
            o = pool_attend_queries(q, pool, tables, qpos,
                                    mode=attend_mode)        # [S, Q, H, Dh]
            x = G._layer_finish(layer, x, o, cfg)
        x = G.rms_norm(x, params["lnf"])
        S = x.shape[0]
        logits = G._head(params, x.reshape(S * Q, 1, x.shape[-1])
                         ).reshape(S, Q, -1)                 # [S, Q, V]
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        # position 0 honours the per-request sampling discipline (sampled
        # slots draft nothing, so only their column 0 is consumed)
        preds[:, 0] = _pick_tokens(logits[:, 0], uid_lo, uid_hi, tcount,
                                   temp, top_k, top_p)
        return preds

    return verify


def _propose_draft(history, K: int, ngram: int = 2):
    """Prompt-lookup drafting: the K tokens that followed the most recent
    earlier occurrence of the trailing ``ngram`` tokens, or []."""
    n = len(history)
    if n < ngram + 1:
        return []
    tail = history[-ngram:]
    for start in range(n - ngram - 1, -1, -1):
        if history[start:start + ngram] == tail:
            nxt = history[start + ngram:start + ngram + K]
            if nxt:
                return list(nxt)
    return []


def _make_prefill(cfg: GPTConfig, block_size: int):
    """Bucketed dense prefill for a group of requests: causal forward
    over the right-padded prompts [n, T], K/V written into each member's
    blocks (padding to scratch), first token from each row's hidden state
    at its true last position."""

    @torch.no_grad()
    def prefill(params, pools, table_rows, tokens, t_real, uid_lo, uid_hi,
                temp, top_k, top_p):
        T = tokens.shape[1]
        pos = torch.arange(T, device=tokens.device)
        x = G.embed(params, tokens, pos, cfg)                # [n, T, D]
        for layer, pool in zip(params["layers"], pools):
            q, kk, v = G._layer_qkv(layer, x, cfg, pos=pos)
            pool_write_prompt_batch(pool, table_rows, kk, v, t_real,
                                    block_size)
            o = G._attend(q, kk, v, "dense", kv_groups=cfg.kv_groups)
            x = G._layer_finish(layer, x, o, cfg)
        x = G.rms_norm(x, params["lnf"])
        last = torch.clamp(t_real.long() - 1, min=0)
        h_last = x[torch.arange(x.shape[0], device=x.device), last]
        logits = G._head(params, h_last[:, None])            # [n, V]
        return _pick_tokens(logits, uid_lo, uid_hi,
                            np.zeros(len(uid_lo), np.int64), temp, top_k,
                            top_p)

    return prefill


class DecodeEngine:
    """Continuous-batching serving loop.

    ``num_blocks`` * ``block_size`` tokens of KV cache are shared by all
    slots; ``max_len`` bounds any single sequence (its table width).
    ``prompt_buckets`` are the prefill lengths (ascending).
    ``decode_chunk`` tokens are decoded per host sync.  ``attend`` picks
    the per-layer cache read: "fused" = the paged-attention CUDA kernel,
    "gather" = materialise-then-attend, "auto" = fused on CUDA.
    ``kv_dtype=torch.int8`` stores the cache quantized (one f32 scale per
    token per KV head, dequantized inside the attend).  ``speculative=K``
    switches the decode loop to speculative decoding with prompt-lookup
    drafts (replaces ``decode_chunk``).  ``device`` defaults to ``cuda``
    and raises without one; pass ``"cpu"`` to run on the CPU.  Matmul
    weights are stored once in ``cfg.dtype`` on the device.
    """

    def __init__(self, params, cfg: GPTConfig, *, num_slots: int = 8,
                 block_size: int = 32, num_blocks: int = 64,
                 max_len: Optional[int] = None,
                 prompt_buckets=(32, 128, 512), decode_chunk: int = 8,
                 prefill_group: Optional[int] = None, on_tokens=None,
                 attend: str = "auto", kv_dtype=None, speculative: int = 0,
                 device=None):
        if attend not in ("auto", "fused", "gather"):
            raise ValueError(f"attend must be auto|fused|gather, "
                             f"got {attend!r}")
        if kv_dtype is not None and kv_dtype != torch.int8:
            raise ValueError("kv_dtype must be None (model dtype) or "
                             "torch.int8")
        self.device = resolve_device(device)
        self.params = G.cast_params(params, cfg, self.device)
        self.cfg = cfg
        self.S = num_slots
        self.bs = block_size
        self.max_len = max_len or cfg.max_seq
        if not cfg.rope and self.max_len > cfg.max_seq:
            raise ValueError("max_len beyond wpe table")
        self.max_blocks = -(-self.max_len // block_size)
        self.buckets = tuple(sorted(b for b in prompt_buckets
                                    if b <= self.max_len))
        if not self.buckets:
            raise ValueError("no prompt bucket fits max_len")
        self.pools = init_paged_pools(cfg, num_blocks, block_size,
                                      kv_dtype=kv_dtype, device=self.device)
        self._total_blocks = num_blocks - 1      # block 0 is scratch
        self._free = collections.deque(range(1, num_blocks))
        self._tables = np.zeros((num_slots, self.max_blocks), np.int32)
        self._pos = np.zeros(num_slots, np.int32)
        self._tok = np.zeros(num_slots, np.int32)
        self._uid_lo = np.zeros(num_slots, np.uint32)
        self._uid_hi = np.zeros(num_slots, np.uint32)
        self._tcount = np.zeros(num_slots, np.int32)
        self._temp = np.zeros(num_slots, np.float32)
        self._topk = np.zeros(num_slots, np.int32)
        self._topp = np.ones(num_slots, np.float32)
        self._running: List[Optional[_Running]] = [None] * num_slots
        self._queue: "collections.deque[Request]" = collections.deque()
        # streaming: a replay after preemption regenerates identical
        # tokens, so _emitted[uid] suppresses re-emission and a consumer
        # never sees a duplicate or a rollback
        self.on_tokens = on_tokens          # fn(uid, new_tokens) or None
        self._emitted: Dict[int, int] = {}
        self._admit_order: List[int] = []    # slots, oldest first
        self._results: Dict[int, List[int]] = {}
        self.K = max(1, decode_chunk)
        self.G = max(1, min(prefill_group or min(num_slots, 8), num_slots))
        self.spec = max(0, int(speculative))
        if self.spec:
            self._verify = _make_verify(cfg, block_size, self.spec, attend)
        else:
            self._decode = _make_decode_chunk(cfg, block_size, self.K,
                                              attend)
        self._prefill = _make_prefill(cfg, block_size)
        self.stats = EngineStats(num_slots)

    def _dev(self, a: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- admin
    def validate_shape(self, req: Request) -> None:
        """Static admissibility checks (no engine state touched, so safe
        to call from an HTTP handler thread)."""
        if not req.prompt or req.max_new < 1:
            raise ValueError(f"request {req.uid}: needs a non-empty "
                             f"prompt and max_new >= 1")
        need = len(req.prompt) + req.max_new
        if need > self.max_len:
            raise ValueError(f"request {req.uid}: prompt+max_new {need} "
                             f"exceeds max_len {self.max_len}")
        if -(-need // self.bs) > self._total_blocks:
            raise ValueError(f"request {req.uid}: needs more KV blocks "
                             f"than the whole pool holds")
        if len(req.prompt) > self.buckets[-1]:
            raise ValueError(f"request {req.uid}: prompt longer than the "
                             f"largest prefill bucket {self.buckets[-1]}")
        if not 0 <= min(req.prompt) <= max(req.prompt) < self.cfg.vocab_size:
            raise ValueError(f"request {req.uid}: prompt token ids must "
                             f"be in [0, {self.cfg.vocab_size})")
        if not (0.0 < req.top_p <= 1.0):
            raise ValueError(f"request {req.uid}: top_p must be in "
                             f"(0, 1], got {req.top_p}")
        if req.top_k < 0:
            raise ValueError(f"request {req.uid}: top_k must be >= 0, "
                             f"got {req.top_k}")

    def submit(self, req: Request) -> None:
        self.validate_shape(req)
        in_flight = ({r.uid for r in self._queue}
                     | {r.req.uid for r in self._running if r is not None}
                     | set(self._results))
        if req.uid in in_flight:
            raise ValueError(f"request uid {req.uid} already in flight "
                             f"(uids key both results and sampling)")
        self._queue.append(req)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise AssertionError  # submit() validated

    def _alloc(self, n: int) -> Optional[List[int]]:
        if len(self._free) < n:
            return None
        return [self._free.popleft() for _ in range(n)]

    def _free_slot(self, slot: int) -> None:
        run = self._running[slot]
        self._free.extend(run.blocks)
        self._running[slot] = None
        self._tables[slot] = 0
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._uid_lo[slot] = 0
        self._uid_hi[slot] = 0
        self._tcount[slot] = 0
        self._temp[slot] = 0.0      # freed slots sample nothing (greedy)
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        self._admit_order.remove(slot)

    def _admit(self) -> None:
        """Admit the longest FCFS run of the queue that shares one prompt
        bucket and fits (free slot + blocks + growth headroom), up to
        ``prefill_group`` requests, and prefill them in one pass.

        Admission hysteresis: while anything is running, wait until
        ``min(prefill_group, queue, S-1)`` slots are free, so freed slots
        accumulate into one group prefill instead of one pass each."""
        free_slots = sum(r is None for r in self._running)
        if self._admit_order and free_slots < min(self.G,
                                                  len(self._queue),
                                                  self.S - 1):
            return
        while self._queue:
            # the head's bucket sets the batch shape; later queue entries
            # of the same bucket may join it (the head is always admitted
            # first, so nothing starves)
            bucket = self._bucket(len(self._queue[0].prompt))
            batch = []                      # (req, slot, blocks)
            picked = []                     # queue indices admitted
            for qi, req in enumerate(self._queue):
                if len(batch) >= self.G:
                    break
                if self._bucket(len(req.prompt)) != bucket:
                    continue
                taken = {s for _, s, _ in batch}
                slot = next((i for i in range(self.S)
                             if self._running[i] is None
                             and i not in taken), None)
                if slot is None:
                    break
                need = -(-len(req.prompt) // self.bs)
                # +1 growth headroom: admitting with exactly the prompt's
                # blocks free would preempt within block_size steps
                if len(self._free) < need + 1 and (self._admit_order
                                                   or batch):
                    break
                own = self._alloc(need)
                if own is None:
                    break
                batch.append((req, slot, own))
                picked.append(qi)
            if not batch:
                return
            for qi in reversed(picked):
                del self._queue[qi]
            n = len(batch)
            toks = np.zeros((n, bucket), np.int32)
            rows = np.zeros((n, self.max_blocks), np.int32)
            t_reals = np.zeros(n, np.int32)
            uid_lo = np.zeros(n, np.uint32)
            uid_hi = np.zeros(n, np.uint32)
            temps = np.zeros(n, np.float32)
            topks = np.zeros(n, np.int32)
            topps = np.ones(n, np.float32)
            for g, (req, slot, blocks) in enumerate(batch):
                toks[g, :len(req.prompt)] = req.prompt
                rows[g, :len(blocks)] = blocks
                t_reals[g] = len(req.prompt)
                uid_lo[g] = req.uid & 0xFFFFFFFF
                uid_hi[g] = (req.uid >> 32) & 0xFFFFFFFF
                temps[g] = req.temperature
                topks[g] = req.top_k
                topps[g] = req.top_p
            tok0s = self._prefill(
                self.params, self.pools, self._dev(rows), self._dev(toks),
                self._dev(t_reals), uid_lo, uid_hi, temps, topks, topps)
            tok0s = tok0s.cpu().numpy()
            self.stats.prefills += 1
            for g, (req, slot, blocks) in enumerate(batch):
                run = _Running(req=req, slot=slot, blocks=blocks, out=[])
                self._tables[slot] = 0
                self._tables[slot, :len(blocks)] = blocks
                tok0 = int(tok0s[g])
                run.out.append(tok0)
                self.stats.tokens_out += 1
                self._running[slot] = run
                self._admit_order.append(slot)
                if self._finished(run):
                    self._harvest(slot)
                    continue
                self._emit(run)
                self._pos[slot] = len(req.prompt)   # next write position
                self._tok[slot] = tok0
                self._uid_lo[slot] = req.uid & 0xFFFFFFFF
                self._uid_hi[slot] = (req.uid >> 32) & 0xFFFFFFFF
                self._tcount[slot] = 1              # tok0 was index 0
                self._temp[slot] = req.temperature
                self._topk[slot] = req.top_k
                self._topp[slot] = req.top_p

    def _finished(self, run: _Running) -> bool:
        return (len(run.out) >= run.req.max_new
                or (run.req.eos is not None and run.out
                    and run.out[-1] == run.req.eos))

    def _emit(self, run: _Running) -> None:
        if self.on_tokens is None:
            return
        seen = self._emitted.get(run.req.uid, 0)
        if len(run.out) > seen:
            self.on_tokens(run.req.uid, run.out[seen:])
            self._emitted[run.req.uid] = len(run.out)

    def _harvest(self, slot: int) -> None:
        run = self._running[slot]
        self._emit(run)
        self._emitted.pop(run.req.uid, None)
        self._results[run.req.uid] = run.out
        self._free_slot(slot)

    def _preempt_for(self, needy_slot: int) -> bool:
        """Free a slot admitted after the needy one (youngest first); if
        the needy slot is itself the youngest, it preempts itself.  The
        oldest request always runs to completion.  Returns False only when
        the needy slot is the sole active one (the pool is too small)."""
        order = self._admit_order
        younger = order[order.index(needy_slot) + 1:]
        victim = younger[-1] if younger else (
            needy_slot if len(order) > 1 else None)
        if victim is None:
            return False
        run = self._running[victim]
        self._queue.appendleft(run.req)
        # its generated-so-far tokens are regenerated on replay: don't
        # count them twice
        self.stats.tokens_out -= len(run.out)
        self._free_slot(victim)
        self.stats.preemptions += 1
        return True

    def _ensure_blocks(self, horizons=None) -> None:
        """Every active slot is about to write its next
        ``min(K, remaining)`` positions (``horizons[slot]`` in speculative
        mode); make sure the blocks holding them exist, preempting if the
        pool is dry.  In-chunk steps past ``remaining`` get no blocks:
        their writes fall through zeroed table entries to scratch."""
        for slot in list(self._admit_order):
            run = self._running[slot]
            if run is None:
                continue
            if horizons is not None:
                horizon = horizons.get(slot, 1)
            else:
                horizon = min(self.K, run.req.max_new - len(run.out))
            bi = (int(self._pos[slot]) + horizon - 1) // self.bs
            while self._running[slot] is run and bi >= len(run.blocks):
                got = self._alloc(1)
                if got is not None:
                    run.blocks.extend(got)
                    self._tables[slot, len(run.blocks) - 1] = got[0]
                elif not self._preempt_for(slot):
                    raise RuntimeError(
                        "KV pool exhausted with a single active request "
                        "— increase num_blocks")

    # -------------------------------------------------------------- run
    def _step_speculative(self) -> bool:
        """Speculative tick: draft via prompt-lookup, one verify pass
        checks every slot's current token + drafts, accept the matching
        prefix + the model's own next token."""
        self._admit()
        drafts: Dict[int, List[int]] = {}
        horizons: Dict[int, int] = {}
        for slot in range(self.S):
            run = self._running[slot]
            if run is None:
                continue
            rem = run.req.max_new - len(run.out)
            if run.req.temperature > 0 or rem <= 1:
                drafts[slot] = []
            else:
                drafts[slot] = run.draft(min(self.spec, rem - 1))
            horizons[slot] = len(drafts[slot]) + 1
        self._ensure_blocks(horizons)
        active = [s for s in range(self.S) if self._running[s] is not None]
        if not active:
            return bool(self._queue)
        Q = self.spec + 1
        draft = np.zeros((self.S, Q), np.int32)
        dlen = np.zeros(self.S, np.int32)
        for slot in active:
            d = drafts.get(slot, [])
            draft[slot, 0] = self._tok[slot]
            draft[slot, 1:1 + len(d)] = d
            dlen[slot] = len(d)
        preds = self._verify(
            self.params, self.pools, self._dev(self._tables),
            self._dev(self._pos), self._dev(draft), self._uid_lo,
            self._uid_hi, self._tcount, self._temp, self._topk, self._topp)
        preds = preds.cpu().numpy()                  # [S, Q]: one sync
        self.stats.decode_steps += Q
        self.stats.dispatches += 1
        for slot in active:
            run = self._running[slot]
            a = 0
            while a < dlen[slot] and draft[slot, a + 1] == preds[slot, a]:
                a += 1
            self.stats.spec_proposed += int(dlen[slot])
            self.stats.spec_accepted += a
            emitted = [int(t) for t in draft[slot, 1:1 + a]] \
                + [int(preds[slot, a])]
            for tok in emitted:
                run.out.append(tok)
                self.stats.tokens_out += 1
                self.stats.slot_steps += 1
                if self._finished(run):
                    self._harvest(slot)
                    break
            else:
                self._emit(run)
                n_new = len(emitted)
                self._pos[slot] += n_new
                self._tok[slot] = emitted[-1]
                self._tcount[slot] += n_new
        return True

    def step(self) -> bool:
        """One scheduler tick: admit, guarantee memory, decode ``K``
        tokens for every active slot, harvest.  Returns False when idle."""
        if self.spec:
            return self._step_speculative()
        self._admit()
        self._ensure_blocks()
        active = [s for s in range(self.S) if self._running[s] is not None]
        if not active:
            return bool(self._queue)
        toks = self._decode(
            self.params, self.pools, self._dev(self._tables),
            self._dev(self._pos), self._dev(self._tok), self._uid_lo,
            self._uid_hi, self._tcount, self._temp, self._topk, self._topp)
        toks = toks.cpu().numpy()                    # [K, S]: one sync
        self.stats.decode_steps += self.K
        self.stats.dispatches += 1
        for slot in active:
            run = self._running[slot]
            for j in range(self.K):
                run.out.append(int(toks[j, slot]))
                self.stats.tokens_out += 1
                self.stats.slot_steps += 1
                if self._finished(run):
                    self._harvest(slot)
                    break
            else:
                self._emit(run)
                self._pos[slot] += self.K
                self._tok[slot] = int(toks[self.K - 1, slot])
                self._tcount[slot] += self.K
        return True

    @property
    def busy(self) -> bool:
        """Anything queued or decoding."""
        return bool(self._queue) or any(r is not None
                                        for r in self._running)

    def take_results(self) -> Dict[int, List[int]]:
        """Pop and return every finished request so far (uid -> tokens)."""
        out, self._results = self._results, {}
        return out

    def run(self, requests) -> Dict[int, List[int]]:
        """Drain ``requests`` through the engine; returns uid -> tokens."""
        t0 = time.perf_counter()
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        self.stats.wall_s += time.perf_counter() - t0
        return self.take_results()
