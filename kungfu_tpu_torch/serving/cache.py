"""Paged KV cache: a block pool + per-slot block tables (counterpart of
kungfu_tpu/serving/cache.py).

* one **pool** per layer, ``[num_blocks, block_size, kv_heads, head_dim]``,
  allocated once on the device.  The JAX package donates the pools
  through every jitted step so XLA updates them in place; here the writes
  are in-place ``index_put_`` on the same tensors;
* a **block table** ``int32 [slots, max_blocks_per_slot]`` mapping each
  slot's logical positions to pool blocks; the host scheduler owns it;
* block 0 is a **scratch block**: inactive slots' table rows and the
  write positions of padding tokens point at it, so masked lanes write
  their garbage harmlessly.

Reads either go through the paged-attention kernel (``"fused"``: pool
bytes read once, no gathered copy, no GQA expansion, int8 dequantized in
registers) or materialise a gathered view and run a dense masked attend
(``"gather"``).
"""
from __future__ import annotations

import math
from typing import List

import torch

from ..models.gpt import GPTConfig, _decode_attend
from ..ops.flash_attention import _expand_kv_heads


def init_paged_pools(cfg: GPTConfig, num_blocks: int, block_size: int,
                     kv_dtype=None, device=None) -> List[dict]:
    """Per-layer K/V pools ``[num_blocks, block_size, kv_heads, Dh]`` in
    the model dtype; block 0 is reserved as scratch.

    ``kv_dtype=torch.int8`` stores tokens as int8 with one f32 scale per
    (token, kv_head): ``{"k", "ks", "v", "vs"}`` per layer."""
    if num_blocks < 2:
        raise ValueError("need >= 2 blocks (block 0 is scratch)")
    if kv_dtype is not None and kv_dtype != torch.int8:
        raise ValueError("kv_dtype must be None (model dtype) or torch.int8")
    shape = (num_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    if kv_dtype == torch.int8:
        sshape = shape[:-1]
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "ks": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "vs": torch.zeros(sshape, dtype=torch.float32,
                                   device=device)}
                for _ in range(cfg.n_layers)]
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def quantize_kv(kv):
    """Symmetric per-(token, head) int8: ``kv`` [..., Dh] ->
    (int8 [..., Dh], f32 scale [...]).  amax/127 scaling, rounding half to
    even; zero rows get scale 0 and dequantize back to zeros."""
    kf = kv.float()
    scale = kf.abs().amax(dim=-1) / 127.0
    q = torch.round(kf / torch.clamp(scale, min=1e-30)[..., None])
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    """Adjoint of :func:`quantize_kv`."""
    return (q.float() * scale[..., None]).to(dtype)


def lookup_blocks(tables, pos, block_size: int):
    """Physical (block, offset) for each slot's write position ``pos``
    [S].  A column past the table is clamped to the last one, as the JAX
    gather clamps: only the discarded in-chunk steps of a finishing slot
    reach it, and they write into that slot's own last block."""
    sidx = torch.arange(tables.shape[0], device=tables.device)
    col = torch.clamp(pos // block_size, max=tables.shape[1] - 1)
    return tables[sidx, col], pos % block_size


def paged_write_token(pool, blk, off, kv):
    """Scatter one token per slot into the pool, in place: ``kv``
    [S, kv_heads, Dh] lands at ``(blk[s], off[s])``.  Slots routed to the
    scratch block may collide; nothing reads scratch contents."""
    pool.index_put_((blk.long(), off.long()), kv)
    return pool


def paged_write_prompt(pool, table_row, kv, t_real, block_size: int):
    """Scatter a whole prompt's K or V ``kv`` [T, kv_heads, Dh] into one
    slot's blocks, in place; positions ``>= t_real`` (right padding)
    go to the scratch block."""
    T = kv.shape[0]
    p = torch.arange(T, device=kv.device)
    blk = torch.where(p < t_real, table_row[p // block_size], 0)
    pool.index_put_((blk.long(), p % block_size), kv)
    return pool


def paged_write_prompt_batch(pool, table_rows, kv, t_real, block_size: int):
    """Batched :func:`paged_write_prompt`: ``kv`` [G, T, ...] for G
    prompts in one scatter.  ``table_rows`` [G, max_blocks]; ``t_real``
    [G] (0 for padding rows: every position goes to scratch)."""
    Gn, T = kv.shape[0], kv.shape[1]
    p = torch.arange(T, device=kv.device)[None, :].expand(Gn, T)
    real = p < t_real[:, None]
    blk = torch.where(real, torch.take_along_dim(
        table_rows.long(), p // block_size, dim=1), 0)
    off = p % block_size
    pool.index_put_((blk.reshape(-1), off.reshape(-1)),
                    kv.reshape((-1,) + tuple(kv.shape[2:])))
    return pool


def paged_gather(pool, tables):
    """[S, max_blocks * block_size, kv_heads, Dh] logical view of every
    slot's cache (unallocated entries read the scratch block and are
    masked out by the attend)."""
    S = tables.shape[0]
    g = pool[tables.long()]                 # [S, MB, bs, H, Dh]
    return g.reshape(S, -1, g.shape[-2], g.shape[-1])


def paged_gather_scales(spool, tables):
    """[S, max_blocks * block_size, kv_heads] logical view of the scale
    planes."""
    S = tables.shape[0]
    g = spool[tables.long()]                # [S, MB, bs, H]
    return g.reshape(S, -1, g.shape[-1])


def paged_decode_attend(q, kc, vc, pos):
    """Per-slot masked decode attention: ``q`` [S, 1, H, Dh]; ``kc``/``vc``
    [S, L, H, Dh] (GQA-expanded); ``pos`` [S].  Delegates to the plain
    decode loop's attend."""
    return _decode_attend(q, kc, vc, pos)


def pool_write_token(pool, blk, off, kkv, vkv):
    """Write one token per slot into a pool dict, in place (model dtype,
    or int8 quantized at write time with its scales on the same
    routing)."""
    if "ks" in pool:
        kq, ks = quantize_kv(kkv)
        vq, vs = quantize_kv(vkv)
        for name, t in (("k", kq), ("ks", ks), ("v", vq), ("vs", vs)):
            paged_write_token(pool[name], blk, off, t)
        return pool
    paged_write_token(pool["k"], blk, off, kkv)
    paged_write_token(pool["v"], blk, off, vkv)
    return pool


def pool_write_prompt_batch(pool, table_rows, kkv, vkv, t_real,
                            block_size: int):
    """Batched prompt write into a pool dict (both cache dtypes)."""
    if "ks" in pool:
        kq, ks = quantize_kv(kkv)
        vq, vs = quantize_kv(vkv)
        parts = (("k", kq), ("ks", ks), ("v", vq), ("vs", vs))
    else:
        parts = (("k", kkv), ("v", vkv))
    for name, t in parts:
        paged_write_prompt_batch(pool[name], table_rows, t, t_real,
                                 block_size)
    return pool


def pool_write_at(pool, tables, qpos, kkv, vkv, block_size: int):
    """Scatter Q tokens per slot at absolute positions ``qpos`` [S, Q]
    (the speculative-verify write).  ``kkv``/``vkv`` [S, Q, kv_heads, Dh].
    Positions past the table's width (padding queries of a near-max_len
    slot) go to scratch explicitly: clamping them into the last column
    would overwrite live cache."""
    limit = tables.shape[1] * block_size
    safe = torch.clamp(qpos, max=limit - 1).long()
    blk = torch.where(qpos < limit,
                      torch.take_along_dim(tables.long(), safe // block_size,
                                           dim=1), 0)
    off = safe % block_size
    flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))
    return pool_write_token(pool, blk.reshape(-1), off.reshape(-1),
                            flat(kkv), flat(vkv))


def _resolve_mode(mode: str, q) -> str:
    if mode == "auto":
        return "fused" if q.device.type == "cuda" else "gather"
    if mode not in ("fused", "gather"):
        raise ValueError(f"unknown paged attend mode {mode!r}")
    return mode


def _materialize(pool, tables, q):
    """The gather path's front half: the logical (gathered, dequantized,
    GQA-expanded) K/V views for both cache layouts."""
    groups = q.shape[2] // pool["k"].shape[2]
    kc = paged_gather(pool["k"], tables)
    vc = paged_gather(pool["v"], tables)
    if "ks" in pool:
        kc = dequantize_kv(kc, paged_gather_scales(pool["ks"], tables),
                           q.dtype)
        vc = dequantize_kv(vc, paged_gather_scales(pool["vs"], tables),
                           q.dtype)
    return _expand_kv_heads(kc, groups), _expand_kv_heads(vc, groups)


def pool_attend(q, pool, tables, pos, *, mode: str = "auto"):
    """The attend dispatcher for one query per slot: ``q`` [S, 1, H, Dh].

    ``mode``: ``"fused"`` runs the paged-attention kernel
    (ops/paged_attention.py); ``"gather"`` materialises then attends;
    ``"auto"`` is fused on a CUDA tensor and gather on a CPU tensor."""
    if _resolve_mode(mode, q) == "fused":
        from ..ops.paged_attention import paged_attention
        return paged_attention(q[:, 0], pool["k"], pool["v"], tables, pos,
                               k_scale=pool.get("ks"),
                               v_scale=pool.get("vs"))[:, None]
    kc, vc = _materialize(pool, tables, q)
    return paged_decode_attend(q, kc, vc, pos)


def pool_attend_queries(q, pool, tables, qpos, *, mode: str = "auto"):
    """Multi-query attend for the speculative verify: ``q`` [S, Q, H, Dh],
    query ``(s, j)`` attends keys at positions ``<= qpos[s, j]``.  Both
    paths sweep the cache once for all Q queries.

    ``qpos`` must be ``pos[:, None] + arange(Q)``; both paths honour only
    the base column ``qpos[:, 0]`` and re-derive the per-query offsets, so
    a caller violating the contract gets the same answer from either."""
    S, Q = q.shape[0], q.shape[1]
    if _resolve_mode(mode, q) == "fused":
        from ..ops.paged_attention import paged_attention_queries
        return paged_attention_queries(
            q, pool["k"], pool["v"], tables,
            qpos[:, 0].to(torch.int32).contiguous(),
            k_scale=pool.get("ks"), v_scale=pool.get("vs"))
    kc, vc = _materialize(pool, tables, q)
    L = kc.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     kc.float()) / math.sqrt(q.shape[-1])
    qpos = qpos[:, :1] + torch.arange(Q, device=q.device)[None, :]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        vc.float()).to(q.dtype)
