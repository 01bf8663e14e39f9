"""Chunked-vocab softmax cross-entropy: the LM loss without the [B, T, V]
logits tensor (counterpart of kungfu_tpu/ops/chunked_ce.py).

    loss[b, t] = logsumexp_v(x[b, t] @ W[:, v]) - x[b, t] @ W[:, y[b, t]]

The forward scans the vocab in chunks with an online logsumexp, so peak
memory is [B, T, chunk]; the backward recomputes each chunk's logits and
accumulates dx and dW chunk by chunk in f32.  No Pallas kernel is
involved: the chunk products are ``torch.matmul``, with f32 results as
the JAX op asks for with ``preferred_element_type=f32`` (bf16 operands
are upcast first, since a bf16 product would round its output).
"""
from __future__ import annotations

import torch

__all__ = ["chunked_cross_entropy"]


def _num_chunks(V: int, chunk: int) -> int:
    if V % chunk:
        raise ValueError(f"vocab {V} not divisible by chunk {chunk}; "
                         f"pad the embedding table or pick a divisor")
    return V // chunk


def _chunk_logits(xf, w, c: int, chunk: int):
    """f32 logits of vocab chunk ``c``: [B, T, chunk]."""
    return torch.matmul(xf, w[:, c * chunk:(c + 1) * chunk].float())


def _target_logit(xf, w, targets):
    """x[b, t] . W[:, y[b, t]] in f32 without any [B, T, V] product."""
    wt = w[:, targets].float()                        # [D, B, T]
    return torch.einsum("btd,dbt->bt", xf, wt)


class _ChunkedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk: int):
        n = _num_chunks(w.shape[1], chunk)
        xf = x.float()
        m = torch.full(x.shape[:-1], float("-inf"), device=x.device)
        s = torch.zeros(x.shape[:-1], device=x.device)
        for c in range(n):
            lg = _chunk_logits(xf, w, c, chunk)
            mn = torch.maximum(m, lg.amax(dim=-1))
            s = s * torch.exp(m - mn) + torch.exp(lg - mn[..., None]).sum(-1)
            m = mn
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.chunk = chunk
        return lse - _target_logit(xf, w, targets)

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        D, V = w.shape
        xf = x.float()
        gx = g.float()[..., None]                     # [B, T, 1]
        dx = torch.zeros_like(xf)
        dw = torch.zeros((D, V), dtype=torch.float32, device=w.device)
        x2 = xf.reshape(-1, D)
        for c in range(_num_chunks(V, chunk)):
            sl = slice(c * chunk, (c + 1) * chunk)
            lg = _chunk_logits(xf, w, c, chunk)       # recompute
            p = torch.exp(lg - lse[..., None]) * gx   # [B, T, chunk]
            dx += torch.matmul(p, w[:, sl].float().t())
            dw[:, sl] = x2.t() @ p.reshape(-1, chunk)
        # the target column: d loss / d logit[y] carries -g
        wt = w[:, targets].float()                    # [D, B, T]
        dx -= torch.einsum("bt,dbt->btd", g.float(), wt)
        dw.index_add_(1, targets.reshape(-1),
                      -(xf * gx).reshape(-1, D).t())
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def chunked_cross_entropy(x, w, targets, chunk: int = 8192):
    """Per-token CE loss [B, T] (f32) for features ``x`` [B, T, D], head
    ``w`` [D, V] and integer targets [B, T]; ``chunk`` divides V."""
    _num_chunks(w.shape[1], chunk)
    return _ChunkedCE.apply(x, w, targets.long(), chunk)
