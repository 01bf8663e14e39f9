"""Dense attention oracle (counterpart of the reference_attention in
kungfu_tpu/parallel/ring_attention.py).  The ring and Ulysses schedules
come with the parallel slice of the port."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, causal: bool = False):
    """Dense softmax attention in f32, ``[B, T, H, D]`` layout; returns
    q's dtype.  Masked scores are ``NEG_INF`` (-1e30), not -inf."""
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
