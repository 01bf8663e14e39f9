"""Sequence parallelism: ring attention, ring attention on the flash
kernels, and Ulysses all-to-all (counterpart of
kungfu_tpu/parallel/ring_attention.py).

Where the JAX functions run inside ``shard_map`` over a named axis, these
run in every rank of a process group (the sp axis of a
:class:`~kungfu_tpu_torch.comm.mesh.ProcessMesh`) on the rank's shard of
the sequence, ``[B, T_local, H, D]``; the global sequence is the
concatenation of the shards in rank order.  The gradients flow through
autograd: the kernels' backward, the log-sum-exp merge, and the
collectives' own backward (``comm.collectives``: the reverse shift of
``ppermute``, the inverse ``all_to_all``).

- :func:`ring_attention`: K/V shards circulate around the ring while each
  rank accumulates its queries' attention over every chunk with the
  online-softmax recurrence, in f32 (dense blocks).
- :func:`ring_flash_attention`: each (queries x KV chunk) block runs on
  the flash kernels K1-K4 (``ops.flash_attention.flash_attention_with_lse``)
  and the chunks merge by log-sum-exp.  Under ``causal`` a chunk from a
  later rank is wholly in the future: its weight is 0, so it is not
  computed (K1-K4 run on the diagonal and the past chunks only, rank + 1
  chunks on rank r), but its K/V still take part in the rotation.
- :func:`ulysses_attention`: one all-to-all re-shards [B, T/n, H, D] to
  [B, T, H/n, D], dense local attention runs on whole sequences for the
  rank's heads, and a second one shards the output back.

Under GQA (``kv_groups`` > 1) k/v travel compact and are expanded only
for the local compute (ring_flash hands them to the kernels compact).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..comm.collectives import all_to_all, ppermute

NEG_INF = -1e30


def _block_attend(q, k, v, acc, m, l, bias):
    """One online-softmax accumulation step (flash recurrence).

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; acc: [B, Tq, H, D];
    m, l: [B, Tq, H] running max / normalizer; bias: [Tq, Tk] additive.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s + bias[None, None, :, :]
    s_max = s.amax(dim=-1)                            # [B, H, Tq]
    m_new = torch.maximum(m, s_max.permute(0, 2, 1))  # [B, Tq, H]
    p = torch.exp(s - m_new.permute(0, 2, 1)[:, :, :, None])
    corr = torch.exp(m - m_new)                       # [B, Tq, H]
    l_new = corr * l + p.sum(dim=-1).permute(0, 2, 1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    acc_new = acc * corr[:, :, :, None] + pv
    return acc_new, m_new, l_new


def _expand_groups(t, groups: int):
    """[B, T, Hkv, D] -> [B, T, Hkv*groups, D] (GQA head expansion)."""
    return t if groups == 1 else t.repeat_interleave(groups, dim=2)


def ring_attention(q, k, v, group, causal: bool = False,
                   kv_groups: int = 1):
    """Blockwise ring attention over the sequence shards of ``group``.

    q, k, v: this rank's shard ``[B, T_local, H, D]`` (k/v with
    ``H / kv_groups`` heads under GQA: the compact form rotates and is
    expanded for each block).  Returns this rank's output shard in q's
    dtype.  The K/V rotate n - 1 times (JAX's loop issues an n-th
    rotation whose result it drops)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    T = q.shape[1]
    q_pos = rank * T + torch.arange(T, device=q.device)

    qf = q.float()
    acc = torch.zeros_like(qf)
    m = torch.full(qf.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros(qf.shape[:-1], device=q.device)
    kc, vc = k, v
    for step in range(n):
        if step:
            kc, vc = ppermute(kc, group), ppermute(vc, group)
        src = (rank - step) % n          # the chunk's home rank
        if causal:
            k_pos = src * T + torch.arange(T, device=q.device)
            bias = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                               NEG_INF)
        else:
            bias = torch.zeros((T, T), device=q.device)
        acc, m, l = _block_attend(
            qf, _expand_groups(kc, kv_groups).float(),
            _expand_groups(vc, kv_groups).float(), acc, m, l, bias)
    # causal: every query row has attended at least its own position
    out = acc / torch.clamp(l, min=1e-30)[:, :, :, None]
    return out.to(q.dtype)


def _is_future(src: int, rank: int) -> bool:
    """A chunk whose home rank comes after this one holds only later
    positions (under ``causal`` its weight is 0)."""
    return src > rank


class _Depend(torch.autograd.Function):
    """``acc`` unchanged, with ``kc``/``vc`` as inputs that get a zero
    gradient: a skipped chunk's K/V stay in the graph, so the backward of
    every rotation runs on every rank (each is a collective)."""

    @staticmethod
    def forward(ctx, acc, kc, vc):
        ctx.like = [(t.shape, t.dtype, t.device) for t in (kc, vc)]
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.like))


def ring_flash_attention(q, k, v, group, causal: bool = False,
                         kv_groups: int = 1):
    """Ring attention whose per-chunk compute is the flash kernels K1-K4.

    Same layout and result as :func:`ring_attention`.  Step 0 is the
    diagonal chunk, run with the kernels' causal mask under ``causal``;
    at step s the chunk that arrives came from rank - s, wholly in the
    past when rank >= s (run without a mask) and wholly in the future
    otherwise.  JAX computes a future chunk and merges it with an lse of
    ``NEG_INF``, weight 0; the port skips its kernels, with the same
    result.  The chunks merge by log-sum-exp in f32.  JAX's block sizes
    are not taken: the CUDA tile is fixed."""
    from ..ops.flash_attention import flash_attention_with_lse
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    o0, lse0 = flash_attention_with_lse(q, k, v, causal,
                                        kv_groups=kv_groups)
    acc = o0.float()
    lse_acc = lse0                                  # [B, H, T_local] f32

    def tohd(w):
        return w.permute(0, 2, 1)[..., None]

    kc, vc = k, v
    for s in range(1, n):
        kc, vc = ppermute(kc, group), ppermute(vc, group)
        if causal and _is_future((rank - s) % n, rank):
            acc = _Depend.apply(acc, kc, vc)
            continue
        oi, lsei = flash_attention_with_lse(q, kc, vc, False,
                                            kv_groups=kv_groups)
        lse_new = torch.logaddexp(lse_acc, lsei)
        w_old = torch.exp(lse_acc - lse_new)
        w_new = torch.exp(lsei - lse_new)
        acc = acc * tohd(w_old) + oi.float() * tohd(w_new)
        lse_acc = lse_new
    return acc.to(q.dtype)


def ulysses_attention(q, k, v, group, causal: bool = False,
                      kv_groups: int = 1):
    """All-to-all (Ulysses/DeepSpeed-style) sequence parallelism.

    Re-shards [B, T/n, H, D] -> [B, T, H/n, D] with one all-to-all, runs
    dense local attention (f32 scores [B, H/n, T, T]) on whole sequences
    for the rank's heads, then shards back.  Needs H and the KV heads
    divisible by n; compact k/v go through the all-to-all and expand
    after it."""
    n = dist.get_world_size(group)
    if q.shape[2] % n != 0:
        raise ValueError(f"heads {q.shape[2]} not divisible by ring {n}")
    if k.shape[2] % n != 0:
        raise ValueError(f"kv heads {k.shape[2]} not divisible by ring {n}")

    def to_heads(x):   # [B, T/n, H, D] -> [B, T, H/n, D]
        return all_to_all(x, group, split_axis=2, concat_axis=1)

    def to_seq(x):     # [B, T, H/n, D] -> [B, T/n, H, D]
        return all_to_all(x, group, split_axis=1, concat_axis=2)

    qh = to_heads(q)
    kh = _expand_groups(to_heads(k), kv_groups)
    vh = _expand_groups(to_heads(v), kv_groups)
    return to_seq(reference_attention(qh, kh, vh, causal=causal))


def reference_attention(q, k, v, causal: bool = False):
    """Dense softmax attention in f32, ``[B, T, H, D]`` layout; returns
    q's dtype.  Masked scores are ``NEG_INF`` (-1e30), not -inf.  The
    correctness oracle and the local kernel of Ulysses."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = s.shape[2], s.shape[3]
        mask = (torch.arange(Tq, device=s.device)[:, None]
                >= torch.arange(Tk, device=s.device)[None, :])
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _sharded(fn, group, **kw):
    """[B, T, H, D] in and out, T sharded over ``group``: each rank takes
    its block of the sequence, runs ``fn`` on it and all-gathers the
    output (forward only: for gradients call ``fn`` on the shards)."""
    from ..comm.collectives import all_gather

    def run(q, k, v):
        n, r = dist.get_world_size(group), dist.get_rank(group)

        def shard(t):
            if t.shape[1] % n:
                raise ValueError(f"sequence {t.shape[1]} does not split "
                                 f"over {n} ranks")
            c = t.shape[1] // n
            return t[:, r * c:(r + 1) * c].contiguous()
        with torch.no_grad():
            out = fn(shard(q), shard(k), shard(v), group, **kw)
            return all_gather(out, group, axis=1, tiled=True)
    return run


def make_ring_attention(group, causal: bool = False, kv_groups: int = 1):
    """[B, T, H, D] attention with T sharded over ``group`` (the JAX
    function's mesh axis; there is no jit)."""
    return _sharded(ring_attention, group, causal=causal,
                    kv_groups=kv_groups)


def make_ulysses_attention(group, causal: bool = False, kv_groups: int = 1):
    """[B, T, H, D] attention, Ulysses schedule."""
    return _sharded(ulysses_attention, group, causal=causal,
                    kv_groups=kv_groups)


def make_ring_flash_attention(group, causal: bool = False,
                              kv_groups: int = 1):
    """[B, T, H, D] ring attention with flash chunks."""
    return _sharded(ring_flash_attention, group, causal=causal,
                    kv_groups=kv_groups)
