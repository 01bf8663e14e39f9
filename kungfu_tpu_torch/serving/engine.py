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
  one verify pass checks the current token plus up to K drafts;
* **int8 weights** (``weights_int8``, W8A16): the matmul weights are
  stored as int8 with per-channel f32 scales (``ops/quant.py``) and each
  layer's weights are dequantized at that layer's use, in every program;
* **prefix cache** (``prefix_cache``): full prompt blocks are shared
  across requests by reference count, and a hit prefills only the
  prompt's suffix, reading the shared blocks through its block table;
* **request journal** (``journal``, ``serving/slo.py``): each request's
  arrival, admissions, first token, preemptions and finish, with the
  SLO evaluation that ``GET /requests`` serves;
* **tensor parallelism** (``mesh``, ``serving/tp.py``): one process per
  tp rank, each with its Megatron shard of the parameters and a pool of
  its KV heads; rank 0 schedules and sends every program to the other
  ranks as a command, and the programs sum their partial products and
  gather the logits over the tp group.

The per-request oracle is ``models.gpt.generate``: greedy requests get
exactly the tokens the plain decoder produces (under int8 weights, on
the dequantized weights).

Left for later slices of the port: the trace events, monitor gauges,
``StepPhases`` and chaos points.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import torch.distributed as dist

from ..comm.mesh import TP_AXIS, ProcessMesh
from ..models import gpt as G
from ..models.gpt import GPTConfig
from ..ops import paged_attention as PA
from ..ops.quant import QuantizedTensor, dequantize_weights, quantize_weights
from ..parallel.threed import shard_params
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves
from .cache import (init_paged_pools, lookup_blocks, pool_attend,
                    pool_attend_queries, pool_write_at,
                    pool_write_prompt_batch, pool_write_token)
from .slo import RequestJournal
from .tp import STOP, Channel, TPComm


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
    # when the request entered the system (perf_counter clock): the
    # front end stamps it, submit() back-fills it, and a preemption
    # re-stamps it on requeue (the current wait)
    arrival_t: Optional[float] = None
    # the original arrival, never re-stamped: the journal's TTFT and
    # e2e include every requeue
    first_arrival_t: Optional[float] = None


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
        self.prefix_hits = 0         # admissions served from the cache
        self.prefix_tokens_reused = 0  # prompt tokens not recomputed
        self.wall_s = 0.0
        # under tp: each rank's counters as of the last dispatch, running
        # totals since the rank started (reset does not reach them): K5
        # launches, the tp collectives' seconds, peak device bytes, and
        # resident weight bytes
        self.ranks: List[Dict[str, float]] = []

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
        if self.prefix_hits:
            out["prefix_hits"] = self.prefix_hits
            out["prefix_tokens_reused"] = self.prefix_tokens_reused
        if self.spec_proposed:
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
            out["spec_accept_rate"] = round(
                self.spec_accepted / self.spec_proposed, 3)
        if self.ranks:
            out["tp_ranks"] = self.ranks
        return out


def _identity(tree):
    return tree


def _weights_at_use(cfg: GPTConfig, weights_int8: bool):
    """``prep(tree)``: one layer's weights (or the LM head's entry) as the
    products use them.  Under int8 weights each QuantizedTensor becomes a
    ``cfg.dtype`` tensor here, one elementwise kernel per weight at that
    layer's use, so no dequantized copy outlives its layer (the JAX
    engine dequantizes inside each jitted program, where XLA fuses it
    into the dot)."""
    if not weights_int8:
        return _identity
    return lambda tree: dequantize_weights(tree, cfg.dtype)


def _logits(params, x, prep, tp=None):
    """f32 logits from ``x`` [B, 1, D]; an int8 LM head is dequantized to
    ``cfg.dtype`` and widened, as the JAX engine's head uses it.  Under
    ``tp`` the rank's vocabulary block is gathered (``G.tp_head``)."""
    local = G._head(prep({"lm_head": params["lm_head"]}), x)
    return local if tp is None else tp.gather(local)


def _psum(tp):
    return None if tp is None else tp.psum


def _decode_core(params, cfg: GPTConfig, block_size: int, pools, tables,
                 pos, tokens, attend_mode: str = "auto", prep=_identity,
                 tp=None):
    """One decode step for every slot: feed each its last token at its
    own position, write K/V through the block tables (inactive slots'
    zeroed rows route to scratch), attend straight off the pool, return
    f32 logits [S, V].  Under ``tp`` (a ``serving.tp.TPComm``) the
    parameters and pools hold the rank's shard, and each layer's partial
    products are summed over the tp group."""
    x = G.embed(params, tokens[:, None], pos[:, None], cfg)
    blk, off = lookup_blocks(tables, pos, block_size)
    for layer, pool in zip(params["layers"], pools):
        layer = prep(layer)
        q, kk, v = G._layer_qkv(layer, x, cfg, pos=pos[:, None])
        pool_write_token(pool, blk, off, kk[:, 0], v[:, 0])
        o = pool_attend(q, pool, tables, pos, mode=attend_mode)
        x = G._decode_finish(layer, x, o, cfg, _psum(tp))
    x = G.rms_norm(x, params["lnf"])
    return _logits(params, x, prep, tp)


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
                       attend_mode: str = "auto", prep=_identity, tp=None):
    """``chunk`` decode steps back to back, each feeding its sampled
    tokens to the next on the device; returns all sampled tokens
    [chunk, S] on the device, so the caller syncs once per chunk (the
    reason the JAX engine runs the chunk as one lax.scan program).  A
    finished sequence's trailing in-chunk steps sample discarded tokens,
    written to the slot's own blocks or scratch.  Under ``tp`` every rank
    samples from the same gathered logits, so the tokens agree."""

    @torch.no_grad()
    def run(params, pools, tables, pos, tokens, uid_lo, uid_hi, tcount,
            temp, top_k, top_p):
        toks = []
        tok = tokens
        for i in range(chunk):
            logits = _decode_core(params, cfg, block_size, pools, tables,
                                  pos + i, tok, attend_mode, prep, tp)
            tok = _pick_tokens(logits, uid_lo, uid_hi, tcount + i, temp,
                               top_k, top_p)
            toks.append(tok)
        return torch.stack(toks)                     # [chunk, S]

    return run


def _make_verify(cfg: GPTConfig, block_size: int, K: int,
                 attend_mode: str = "auto", prep=_identity, tp=None):
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
            layer = prep(layer)
            q, kk, v = G._layer_qkv(layer, x, cfg, pos=qpos)
            pool_write_at(pool, tables, qpos, kk, v, block_size)
            o = pool_attend_queries(q, pool, tables, qpos,
                                    mode=attend_mode)        # [S, Q, H, Dh]
            x = G._decode_finish(layer, x, o, cfg, _psum(tp))
        x = G.rms_norm(x, params["lnf"])
        S = x.shape[0]
        logits = _logits(params, x.reshape(S * Q, 1, x.shape[-1]),
                         prep, tp).reshape(S, Q, -1)         # [S, Q, V]
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


def _last_logits(params, x, t_real, prep, tp=None):
    """f32 logits [n, V] from each prefill row's hidden state at its true
    last position ``t_real - 1``."""
    x = G.rms_norm(x, params["lnf"])
    last = torch.clamp(t_real.long() - 1, min=0)
    h_last = x[torch.arange(x.shape[0], device=x.device), last]
    return _logits(params, h_last[:, None], prep, tp)


def _prefill_features(params, cfg: GPTConfig, block_size: int, pools,
                      table_rows, tokens, t_real, prep=_identity, tp=None):
    """The full-prompt prefill's layers: causal forward over the
    right-padded prompts [n, T], K/V written into each row's blocks
    (padding to scratch); returns the last layer's output [n, T, D].
    Under ``tp`` the rank's heads attend (the GQA group ratio is the
    same on every rank) and the partial products are summed."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = G.embed(params, tokens, pos, cfg)                    # [n, T, D]
    for layer, pool in zip(params["layers"], pools):
        layer = prep(layer)
        q, kk, v = G._layer_qkv(layer, x, cfg, pos=pos)
        pool_write_prompt_batch(pool, table_rows, kk, v, t_real, block_size)
        o = G._attend(q, kk, v, "dense", kv_groups=cfg.kv_groups)
        x = G._decode_finish(layer, x, o, cfg, _psum(tp))
    return x


def _prefill_cached_features(params, cfg: GPTConfig, block_size: int, pools,
                             table_rows, tokens, t_real, t_cached,
                             prep=_identity, tp=None):
    """The suffix prefill's layers: each row's prompt suffix (positions
    ``t_cached .. t_cached + t_real - 1``) runs the dense forward, its
    K/V are written to the row's own blocks at those absolute positions,
    and the attend reads the whole cache through the block table: the
    shared prefix blocks plus the suffix just written, one gathered pass
    per layer.  Returns the last layer's output [n, T, D].

    The attend is the gather path (``pool_attend_queries(mode=
    "gather")``), as in the JAX engine: K5's multi-query form serves the
    1-16 rows of a verify, not a bucket of prompt rows."""
    rel = torch.arange(tokens.shape[1], device=tokens.device)
    qpos = t_cached.long()[:, None] + rel[None, :]           # [n, T]
    x = G.embed(params, tokens, qpos, cfg)
    # pad positions (rel >= t_real) go to scratch: their qpos points into
    # allocated blocks, where a write would corrupt live cache
    limit = table_rows.shape[1] * block_size
    wpos = torch.where(rel[None, :] < t_real.long()[:, None], qpos, limit)
    for layer, pool in zip(params["layers"], pools):
        layer = prep(layer)
        q, kk, v = G._layer_qkv(layer, x, cfg, pos=qpos)
        pool_write_at(pool, table_rows, wpos, kk, v, block_size)
        o = pool_attend_queries(q, pool, table_rows, qpos, mode="gather")
        x = G._decode_finish(layer, x, o, cfg, _psum(tp))
    return x


def _make_prefill(cfg: GPTConfig, block_size: int, prep=_identity, tp=None):
    """Bucketed dense prefill for a group of requests: the layers of
    :func:`_prefill_features`, then each row's first token (index 0 of
    its stream) from its true last position."""

    @torch.no_grad()
    def prefill(params, pools, rows, tokens, t_real, uid_lo, uid_hi, temp,
                top_k, top_p):
        x = _prefill_features(params, cfg, block_size, pools, rows, tokens,
                              t_real, prep, tp)
        return _pick_tokens(_last_logits(params, x, t_real, prep, tp),
                            uid_lo, uid_hi, np.zeros(len(uid_lo), np.int64),
                            temp, top_k, top_p)

    return prefill


def _make_prefill_cached(cfg: GPTConfig, block_size: int, prep=_identity,
                         tp=None):
    """Suffix prefill for prefix-cache hits: the layers of
    :func:`_prefill_cached_features` (the prefix's projections, FFN and
    attention are skipped), then each row's first token.  Model-dtype
    pools only, so a cached prefix holds the values a recomputed one
    would."""

    @torch.no_grad()
    def prefill(params, pools, rows, tokens, t_real, t_cached, uid_lo,
                uid_hi, temp, top_k, top_p):
        x = _prefill_cached_features(params, cfg, block_size, pools, rows,
                                     tokens, t_real, t_cached, prep, tp)
        return _pick_tokens(_last_logits(params, x, t_real, prep, tp),
                            uid_lo, uid_hi, np.zeros(len(uid_lo), np.int64),
                            temp, top_k, top_p)

    return prefill


# the programs' arguments that go to the device (the rest are host arrays)
_DEVICE_ARGS = ("tables", "pos", "tokens", "draft", "rows", "t_real",
                "t_cached")
# each tp rank's counters, in the order its token check carries them
_RANK_COUNTERS = ("k5_launches", "collective_s", "peak_bytes",
                  "weight_bytes")


def resident_bytes(tree) -> int:
    """Resident bytes of a parameter tree (an int8 weight counts its q and
    its scale)."""
    return sum(t.numel() * t.element_size() for leaf in tree_leaves(tree)
               for t in ((leaf.q, leaf.scale)
                         if isinstance(leaf, QuantizedTensor) else (leaf,)))


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

    ``weights_int8=True`` stores every matmul weight and the LM head as
    int8 with per-channel scales (``ops.quant.quantize_weights`` of the
    caller's f32 tree, before any cast), about half the resident weight
    bytes; ``weights_int8_min_size=N`` quantizes only weights of at
    least N elements.  Each layer's weights are dequantized at their use.
    ``prefix_cache=True`` shares prompt-prefix KV across requests: full
    blocks are keyed by their token prefix with reference counts; an
    admission whose prefix is cached prefills only its suffix, reading
    the shared blocks through its table.  Unreferenced cached blocks form
    an LRU the allocator evicts under pressure.  A preempted request pins
    its prefix split so its replay is numerically the same (streamed
    tokens never roll back).  Requests admitted in one batched prefill
    cannot share with each other (entries land after the prefill);
    model-dtype pools only.  ``journal`` (a ``serving.slo.RequestJournal``
    with the default SLOs and no sink; replace it before the first
    submit to change either) records every request's lifecycle.

    ``mesh`` (``comm.mesh.serving_mesh(n)``) switches on tensor-parallel
    serving: every rank of the mesh constructs the engine with the same
    arguments and the same full ``params`` tree (quantized first under
    ``weights_int8``, then sharded: ``parallel.threed.shard_params``),
    and holds its Megatron shard and pools of ``kv_heads / n`` KV heads.
    Rank 0 is the driver: ``submit``, ``step``, ``run`` and a
    ``ServingServer`` work as without tp, and each program is sent to the
    other ranks first (``serving/tp.py``); the others call :meth:`follow`
    until rank 0's :meth:`close`.  The constructor returns once every
    rank has built its shard.
    """

    def __init__(self, params, cfg: GPTConfig, *, num_slots: int = 8,
                 block_size: int = 32, num_blocks: int = 64,
                 max_len: Optional[int] = None,
                 prompt_buckets=(32, 128, 512), decode_chunk: int = 8,
                 prefill_group: Optional[int] = None, on_tokens=None,
                 attend: str = "auto", kv_dtype=None, speculative: int = 0,
                 prefix_cache: bool = False, weights_int8: bool = False,
                 weights_int8_min_size: int = 0, device=None,
                 mesh: Optional[ProcessMesh] = None):
        if attend not in ("auto", "fused", "gather"):
            raise ValueError(f"attend must be auto|fused|gather, "
                             f"got {attend!r}")
        if kv_dtype is not None and kv_dtype != torch.int8:
            raise ValueError("kv_dtype must be None (model dtype) or "
                             "torch.int8")
        if prefix_cache and kv_dtype is not None:
            raise ValueError(
                "prefix_cache requires the model-dtype pool: the int8 "
                "cache would substitute dequantized prefix values where "
                "an uncached prefill attends fresh ones")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rank, ntp = 0, 1
        self.tp = self._channel = None
        if mesh is not None:
            if mesh.control is None:
                raise ValueError("the serving mesh needs its control group "
                                 "(comm.mesh.serving_mesh)")
            ntp = mesh.size(TP_AXIS)
            G.validate_tp(cfg, ntp)
            self.rank = mesh.index(TP_AXIS)
            self.tp = TPComm(mesh.group(TP_AXIS), self.device)
            self._channel = Channel(mesh.control)
        self._closed = False
        self.weights_int8 = bool(weights_int8)
        if self.weights_int8:
            # quantize the caller's tree as it is: cast_params would
            # round the matmul weights to cfg.dtype first, and that
            # quantizes to other q and scale values than the JAX engine's
            params = quantize_weights(params, min_size=weights_int8_min_size)
        if mesh is not None:
            # after quantizing: the scales reduce over the full weights
            params = shard_params(params, cfg, mesh)
        prep = _weights_at_use(cfg, self.weights_int8)
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
                                      kv_dtype=kv_dtype, device=self.device,
                                      tp=ntp)
        self._total_blocks = num_blocks - 1      # block 0 is scratch
        self._free = collections.deque(range(1, num_blocks))
        # ---- prefix cache: refcounted shared prompt blocks ----
        # a block is in exactly one place: _free (uncached, ref 0),
        # _reclaim (cached, ref 0: the evictable LRU), or held by >= 1
        # running slots (ref > 0, cached or not).  Entries key on the
        # full token prefix through that block, so identical prompt
        # prefixes land on the same physical blocks.
        self.prefix_cache = bool(prefix_cache)
        self._block_ref = np.zeros(num_blocks, np.int32)
        self._block_key: Dict[int, bytes] = {}
        self._prefix_index: Dict[bytes, int] = {}
        self._reclaim: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        # per-uid admission split (prompt tokens served from the cache),
        # and the prefix blocks a preempted uid keeps referenced so its
        # replay re-admits with the same split and values
        self._admit_split: Dict[int, int] = {}
        self._pinned: Dict[int, List[int]] = {}
        # uids whose pins had to be dropped (an all-prefix victim under
        # extreme pressure): their replay runs at t_cached = 0, so the
        # split is at least deterministic; in bf16 the re-prefilled
        # stream can still differ from the cached-split original on a
        # near-tie argmax (needs prefix_cache + streaming + a pin drop)
        self._force_fresh: set = set()
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
        tp = self.tp
        self._programs = {"prefill": _make_prefill(cfg, block_size, prep,
                                                   tp)}
        if self.spec:
            self._programs["verify"] = _make_verify(
                cfg, block_size, self.spec, attend, prep, tp)
        else:
            self._programs["decode"] = _make_decode_chunk(
                cfg, block_size, self.K, attend, prep, tp)
        if self.prefix_cache:
            self._programs["prefill_cached"] = _make_prefill_cached(
                cfg, block_size, prep, tp)
        self.stats = EngineStats(num_slots)
        self.journal = RequestJournal()
        if mesh is not None:
            self._weight_bytes = resident_bytes(self.params)
            self._exchange(np.zeros(0, np.int32))   # every rank is built

    def _dev(self, a: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------ programs, tp
    def _dispatch(self, op: str, **arrays) -> np.ndarray:
        """Run program ``op`` on host ``arrays``; under tp, send it to the
        other ranks first.  Returns its tokens on the host."""
        if self._channel is not None:
            self._channel.send(op, arrays)
        return self._run(op, arrays)

    def _run(self, op: str, arrays) -> np.ndarray:
        args = {k: self._dev(v) if k in _DEVICE_ARGS else v
                for k, v in arrays.items()}
        toks = self._programs[op](self.params, self.pools,
                                  **args).cpu().numpy()
        if self.tp is not None:
            self._exchange(toks)
        return toks

    def _exchange(self, toks: np.ndarray) -> None:
        """Under tp, after each program: one all-gather over the control
        group of every rank's tokens and counters.  Raises unless every
        rank's tokens equal rank 0's (on every rank, so all stop); keeps
        the counters in ``stats.ranks``."""
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        mine = torch.from_numpy(np.concatenate([
            toks.reshape(-1).astype(np.float64),
            np.asarray([PA.launches, self.tp.settle(), peak,
                        self._weight_bytes], np.float64)]))
        parts = [torch.empty_like(mine) for _ in range(self.tp.size)]
        dist.all_gather(parts, mine, group=self.mesh.control)
        n = toks.size
        for r, part in enumerate(parts):
            if not torch.equal(part[:n], parts[0][:n]):
                raise RuntimeError(
                    f"tensor-parallel rank {r} picked other tokens than "
                    f"rank 0: {part[:n].long().tolist()} != "
                    f"{parts[0][:n].long().tolist()}")
        self.stats.ranks = [dict(zip(_RANK_COUNTERS, part[n:].tolist()))
                            for part in parts]

    def follow(self) -> None:
        """A follower's loop (tp ranks other than 0): run every program
        rank 0 sends, on this rank's shard, until rank 0 sends stop."""
        if self._channel is None or self.rank == 0:
            raise RuntimeError("follow() is for tp ranks other than 0")
        while True:
            op, arrays = self._channel.recv()
            if op == STOP:
                return
            self._run(op, arrays)

    def close(self) -> None:
        """Rank 0 under tp: send the other ranks the stop command (once).
        Nothing to do without tp."""
        if self._channel is not None and self.rank == 0 and not self._closed:
            self._closed = True
            self._channel.send(STOP, {})

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
        if req.arrival_t is None:
            req.arrival_t = time.perf_counter()
        if req.first_arrival_t is None:
            req.first_arrival_t = req.arrival_t
        self.journal.on_submit(req.uid, req.first_arrival_t,
                               len(req.prompt))
        self._queue.append(req)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise AssertionError  # submit() validated

    def _available(self) -> int:
        return len(self._free) + len(self._reclaim)

    def _alloc(self, n: int) -> Optional[List[int]]:
        if self._available() < n:
            return None
        while len(self._free) < n:
            # evict the least recently freed cached block (its cache
            # entry dies; the block itself is reused)
            key, blk = self._reclaim.popitem(last=False)
            self._prefix_index.pop(key, None)
            self._block_key.pop(blk, None)
            self._free.append(blk)
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._block_ref[b] = 1
        return out

    def _acquire_shared(self, blk: int) -> None:
        """Take a reference on a cached block (reviving it from the
        reclaim list if no running slot holds it)."""
        if self._block_ref[blk] == 0:
            key = self._block_key.get(blk)
            if key is not None:
                self._reclaim.pop(key, None)
        self._block_ref[blk] += 1

    def _release_block(self, blk: int) -> None:
        self._block_ref[blk] -= 1
        if self._block_ref[blk] < 0:
            raise AssertionError(f"block {blk} released more often than "
                                 f"it was taken")
        if self._block_ref[blk] == 0:
            key = self._block_key.get(blk)
            if key is not None:
                self._reclaim[key] = blk     # cached: evictable, LRU
                self._reclaim.move_to_end(key)
            else:
                self._free.append(blk)

    @staticmethod
    def _chain_keys(prompt, bs, n_blocks):
        """Chained blake2b digests of the prompt's full blocks: key j
        commits to every token through block j at O(bs) per block.
        16-byte digests (a collision would serve wrong KV, hence a real
        hash); the same seed and bytes as the JAX engine, so the same
        prompts give the same keys."""
        key = b"kft-prefix"
        for j in range(n_blocks):
            h = hashlib.blake2b(key, digest_size=16)
            h.update(np.asarray(prompt[j * bs:(j + 1) * bs],
                                np.int64).tobytes())
            key = h.digest()
            yield key

    def _probe_prefix(self, req: Request):
        """(shared_blocks, t_cached) for this request under the cache.

        A replayed (preempted) uid reuses its pinned split as it was, the
        same physical prefix blocks and t_cached, so its re-prefill is
        numerically the same as the original and the tokens already
        streamed stay valid.  A fresh request probes the longest
        contiguous run of cached full blocks, capped one token short of
        the prompt (the prefill needs a query position for the first
        token)."""
        if not self.prefix_cache or req.uid in self._force_fresh:
            return [], 0
        if req.uid in self._pinned:
            return (self._pinned[req.uid],
                    self._admit_split.get(req.uid, 0))
        p = req.prompt
        shared = []
        n_full = (len(p) - 1) // self.bs      # >= 1 suffix token
        for key in self._chain_keys(p, self.bs, n_full):
            blk = self._prefix_index.get(key)
            if blk is None:
                break
            shared.append(blk)
        return shared, len(shared) * self.bs

    def _cache_insert(self, req: Request, blocks: List[int]) -> None:
        """Register this prompt's full blocks in the prefix index (the
        first sharer's physical blocks win; later identical prompts keep
        their own copies uncached)."""
        if not self.prefix_cache:
            return
        p = req.prompt
        for j, key in enumerate(self._chain_keys(p, self.bs,
                                                 len(p) // self.bs)):
            if key in self._prefix_index:
                continue
            blk = blocks[j]
            if blk in self._block_key:     # already caches another key
                continue
            self._prefix_index[key] = blk
            self._block_key[blk] = key

    def _free_slot(self, slot: int, keep: int = 0) -> None:
        """Release the slot's blocks except its first ``keep`` (a
        preempted request's pinned prefix)."""
        run = self._running[slot]
        for b in run.blocks[keep:]:
            self._release_block(b)
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
        """Admit the longest FCFS run of the queue that shares one prefill
        bucket and fits (free slot + blocks + growth headroom), up to
        ``prefill_group`` requests, and prefill them in one pass.  Under
        the prefix cache the bucket is that of the suffix still to
        compute.

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
            head_probe = self._probe_prefix(self._queue[0])
            bucket = self._bucket(len(self._queue[0].prompt)
                                  - head_probe[1])
            batch = []                      # (req, slot, blocks, t_cached)
            picked = []                     # queue indices admitted
            for qi, req in enumerate(self._queue):
                if len(batch) >= self.G:
                    break
                shared, t_cached = (head_probe if qi == 0
                                    else self._probe_prefix(req))
                if self._bucket(len(req.prompt) - t_cached) != bucket:
                    continue
                taken = {s for _, s, *_ in batch}
                slot = next((i for i in range(self.S)
                             if self._running[i] is None
                             and i not in taken), None)
                if slot is None:
                    break
                need = -(-len(req.prompt) // self.bs) - len(shared)
                # +1 growth headroom: admitting with exactly the prompt's
                # blocks free would preempt within block_size steps
                if self._available() < need + 1 and (self._admit_order
                                                     or batch):
                    break
                pinned = req.uid in self._pinned
                if not pinned:
                    # take references before _alloc: an eviction inside
                    # it must not reclaim a block this request will read
                    for b in shared:
                        self._acquire_shared(b)
                own = self._alloc(need)
                if own is None:
                    if not pinned:
                        for b in shared:
                            self._release_block(b)
                    break
                self._pinned.pop(req.uid, None)
                batch.append((req, slot, shared + own, t_cached))
                picked.append(qi)
            if not batch:
                return
            for qi in reversed(picked):
                del self._queue[qi]
            n = len(batch)
            toks = np.zeros((n, bucket), np.int32)
            rows = np.zeros((n, self.max_blocks), np.int32)
            t_reals = np.zeros(n, np.int32)
            t_cacheds = np.zeros(n, np.int32)
            uid_lo = np.zeros(n, np.uint32)
            uid_hi = np.zeros(n, np.uint32)
            temps = np.zeros(n, np.float32)
            topks = np.zeros(n, np.int32)
            topps = np.ones(n, np.float32)
            for g, (req, slot, blocks, t_cached) in enumerate(batch):
                suffix = req.prompt[t_cached:]
                toks[g, :len(suffix)] = suffix
                rows[g, :len(blocks)] = blocks
                t_reals[g] = len(suffix)
                t_cacheds[g] = t_cached
                uid_lo[g] = req.uid & 0xFFFFFFFF
                uid_hi[g] = (req.uid >> 32) & 0xFFFFFFFF
                temps[g] = req.temperature
                topks[g] = req.top_k
                topps[g] = req.top_p
            sampling = dict(uid_lo=uid_lo, uid_hi=uid_hi, temp=temps,
                            top_k=topks, top_p=topps)
            if t_cacheds.any():
                # at least one cached prefix: the suffix program (reads
                # the shared blocks through the tables)
                tok0s = self._dispatch("prefill_cached", rows=rows,
                                       tokens=toks, t_real=t_reals,
                                       t_cached=t_cacheds, **sampling)
                self.stats.prefix_hits += int((t_cacheds > 0).sum())
                self.stats.prefix_tokens_reused += int(t_cacheds.sum())
            else:
                # all-fresh batch: the original full-prompt program (the
                # same numbers as the cache-off engine)
                tok0s = self._dispatch("prefill", rows=rows, tokens=toks,
                                       t_real=t_reals, **sampling)
            self.stats.prefills += 1
            now = time.perf_counter()
            for req, slot, _, t_cached in batch:
                wait = now - req.arrival_t
                self.journal.on_admit(req.uid, now, slot=slot,
                                      prefix_reused=t_cached, wait_s=wait)
                # tok0 came out of this prefill; set once, so a replay's
                # re-prefill does not move it
                self.journal.on_first_token(req.uid, now)
            for g, (req, slot, blocks, t_cached) in enumerate(batch):
                self._admit_split[req.uid] = t_cached
                self._cache_insert(req, blocks)
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
        self.journal.on_finish(run.req.uid, time.perf_counter(),
                               output_tokens=len(run.out))
        self._emitted.pop(run.req.uid, None)
        self._results[run.req.uid] = run.out
        self._admit_split.pop(run.req.uid, None)
        self._force_fresh.discard(run.req.uid)
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
        # requeued: the current-wait clock restarts; first_arrival_t, and
        # the journal's arrival with it, stay
        run.req.arrival_t = time.perf_counter()
        self.journal.on_preempt(run.req.uid)
        self._queue.appendleft(run.req)
        # its generated-so-far tokens are regenerated on replay: don't
        # count them twice
        self.stats.tokens_out -= len(run.out)
        uid = run.req.uid
        # under the prefix cache, keep references on the prefix blocks
        # the replay's split needs: a replay must re-admit at the same
        # t_cached on the same blocks to regenerate the same tokens
        pin = (self._admit_split.get(uid, 0) // self.bs
               if self.prefix_cache else 0)
        kept = run.blocks[:pin]
        before = self._available()
        self._free_slot(victim, keep=pin)
        if kept and self._available() == before:
            # pinning freed nothing (the victim was all prefix): progress
            # beats the pin; drop it and the split record (the replay
            # prefills from scratch)
            for b in kept:
                self._release_block(b)
            self._admit_split.pop(uid, None)
            self._force_fresh.add(uid)
        elif kept:
            self._pinned[uid] = kept
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
    def _slot_sampling(self) -> dict:
        return dict(uid_lo=self._uid_lo, uid_hi=self._uid_hi,
                    tcount=self._tcount, temp=self._temp, top_k=self._topk,
                    top_p=self._topp)

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
        preds = self._dispatch("verify", tables=self._tables, pos=self._pos,
                               draft=draft, **self._slot_sampling())
        # preds [S, Q]: one sync
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
        toks = self._dispatch("decode", tables=self._tables, pos=self._pos,
                              tokens=self._tok, **self._slot_sampling())
        # toks [K, S]: one sync
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
