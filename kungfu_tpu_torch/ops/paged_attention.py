"""Paged-decode attention straight off the paged KV pool (K5).

Counterpart of kungfu_tpu/ops/paged_attention.py.  The JAX package runs
this as a Pallas TPU kernel (``_pa_kernel``); here it is a CUDA C++
kernel for Hopper, ``csrc/paged_attention.cu``, built with nvcc at first
use and called through ctypes (``_build.py``).

* :func:`paged_attention` / :func:`paged_attention_queries` are the
  wrappers the serving cache calls.  On a CUDA tensor they launch the
  kernel (or raise); on a CPU tensor they run the plain version.
* :func:`paged_attention_ref` / :func:`paged_attention_queries_ref` are
  the plain PyTorch version: gather the slot's blocks, dequantize,
  expand GQA, dense masked softmax -- what ``serving.cache``'s gather
  path computes.  The CPU tests hold it against the JAX kernel, and
  ``chip_smoke.py`` holds the kernel against it on the card.
* ``launches`` counts kernel launches (and nothing else), so a run can
  show that its decode steps went through the kernel.

Layouts are the JAX package's: q ``[S, H, Dh]`` or ``[S, Q, H, Dh]``;
pools ``[N, bs, KVH, Dh]`` (model dtype, or int8 with f32 scales
``[N, bs, KVH]``); tables int32 ``[S, MB]`` (0 = scratch block); pos int32
``[S]``, each >= 0 (idle slots carry pos 0 and a scratch table).  Query
``j`` of slot ``s`` attends keys at positions ``<= pos[s] + j``; query
head ``h`` reads KV head ``h // (H // KVH)``.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import _expand_kv_heads

NEG_INF = -1e30

# kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _validate(q, k_pool, k_scale, v_scale) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    H, KVH = q.shape[-2], k_pool.shape[2]
    if H % KVH:
        raise ValueError(f"n_heads {H} not a multiple of kv_heads {KVH}")


def paged_attention_queries_ref(q, k_pool, v_pool, tables, pos, *,
                                k_scale=None, v_scale=None):
    """Plain version of the kernel, multi-query form: ``q``
    [S, Q, H, Dh] -> [S, Q, H, Dh] in q's dtype."""
    _validate(q, k_pool, k_scale, v_scale)
    S, Q, H, Dh = q.shape
    KVH = k_pool.shape[2]
    idx = tables.long()
    kc = k_pool[idx].reshape(S, -1, KVH, Dh)        # [S, MB*bs, KVH, Dh]
    vc = v_pool[idx].reshape(S, -1, KVH, Dh)
    if k_scale is not None:
        ks = k_scale[idx].reshape(S, -1, KVH, 1)
        vs = v_scale[idx].reshape(S, -1, KVH, 1)
        kc = (kc.float() * ks).to(q.dtype)
        vc = (vc.float() * vs).to(q.dtype)
    kc = _expand_kv_heads(kc, H // KVH)
    vc = _expand_kv_heads(vc, H // KVH)
    L = kc.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     kc.float()) / math.sqrt(Dh)
    qpos = (pos.long()[:, None]
            + torch.arange(Q, device=q.device)[None, :])    # [S, Q]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]                   # [S, 1, Q, L]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vc.float()).to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, tables, pos, *, k_scale=None,
                        v_scale=None):
    """Plain version, one query per slot: ``q`` [S, H, Dh]."""
    return paged_attention_queries_ref(q[:, None], k_pool, v_pool, tables,
                                       pos, k_scale=k_scale,
                                       v_scale=v_scale)[:, 0]


def _launch(q, k_pool, v_pool, tables, pos, k_scale, v_scale):
    """Launch the CUDA kernel on the current stream: ``q`` [S, Q, H, Dh]."""
    global launches
    S, Q, H, Dh = q.shape
    N, bs, KVH, Dh_pool = k_pool.shape
    quant = k_scale is not None
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_attention: q dtype {q.dtype} is not "
                        f"float32 or bfloat16")
    kv_dtype = torch.int8 if quant else q.dtype
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "tables": tables, "pos": pos}
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    want = {"k_pool": kv_dtype, "v_pool": kv_dtype, "tables": torch.int32,
            "pos": torch.int32, "k_scale": torch.float32,
            "v_scale": torch.float32}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
        if name in want and t.dtype != want[name]:
            raise TypeError(f"paged_attention: {name} dtype {t.dtype}, "
                            f"expected {want[name]}")
    if (v_pool.shape != k_pool.shape or Dh_pool != Dh
            or tables.dim() != 2 or tables.shape[0] != S
            or pos.shape != (S,)):
        raise ValueError(
            f"paged_attention: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(tables.shape)}, pos {tuple(pos.shape)} do not agree")
    if quant and (k_scale.shape != (N, bs, KVH)
                  or v_scale.shape != (N, bs, KVH)):
        raise ValueError("paged_attention: scales must be [N, bs, KVH]")
    # the kernel stages pool rows with 16-byte loads
    if ((Dh * k_pool.element_size()) % 16 or k_pool.data_ptr() % 16
            or v_pool.data_ptr() % 16):
        raise ValueError("paged_attention: head_dim * itemsize must be a "
                         "multiple of 16 bytes and the pools 16-byte "
                         "aligned")
    from . import _build
    lib = _build.load("paged_attention")
    MB = tables.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.kft_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), S, Q, H,
            KVH, Dh, bs, MB,
            _DTYPE_CODES[q.dtype], int(quant), 1.0 / math.sqrt(Dh), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def paged_attention_queries(q, k_pool, v_pool, tables, pos, *,
                            k_scale=None, v_scale=None):
    """Multi-query decode attention: ``q`` [S, Q, H, Dh]; one pool sweep
    serves all Q queries.  Returns [S, Q, H, Dh] in q's dtype."""
    _validate(q, k_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_queries_ref(q, k_pool, v_pool, tables, pos,
                                           k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, tables, pos, k_scale, v_scale)


def paged_attention(q, k_pool, v_pool, tables, pos, *, k_scale=None,
                    v_scale=None):
    """Decode attention, one token per slot: ``q`` [S, H, Dh] ->
    [S, H, Dh] in q's dtype."""
    return paged_attention_queries(q[:, None], k_pool, v_pool, tables, pos,
                                   k_scale=k_scale, v_scale=v_scale)[:, 0]
