"""BERT-style pre-LN transformer encoder with an MLM head (counterpart of
kungfu_tpu/models/bert.py).

Matmuls run in ``dtype`` (parameters stay f32 and are cast at each use);
the layer norms, the attention logits and their softmax, and the MLM
head run in f32, as in the flax model.  flax's defaults where torch's
differ: LayerNorm epsilon 1e-6, GELU in its tanh form.  The fused
``qkv`` projection splits as [q | k | v] on its last axis; ``mask`` is
True where a key may be attended, and -1e9 replaces the logit elsewhere.
Submodules carry flax's names for
:func:`kungfu_tpu_torch.convert.load_flax_variables`.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .simple import _dense

__all__ = ["BertEncoder", "bert_base", "bert_tiny"]

LN_EPS = 1e-6                    # flax nn.LayerNorm's default


def _layer_norm(ln: nn.LayerNorm, x):
    """flax ``nn.LayerNorm(dtype=f32)``: statistics, scale, bias and
    result in f32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


class MultiHeadAttention(nn.Module):
    def __init__(self, d: int, num_heads: int, dtype):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x, mask=None):
        b, s, d = x.shape
        hd = d // self.num_heads
        q, k, v = _dense(self.qkv, x, self.dtype).split(d, dim=-1)
        q, k, v = (t.reshape(b, s, self.num_heads, hd) for t in (q, k, v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        scores = scores / math.sqrt(hd)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :].bool(), -1e9)
        probs = scores.softmax(dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
        return _dense(self.proj, out, self.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, num_heads: int, mlp_dim: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = nn.LayerNorm(d, eps=LN_EPS)
        self.MultiHeadAttention_0 = MultiHeadAttention(d, num_heads, dtype)
        self.LayerNorm_1 = nn.LayerNorm(d, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d, mlp_dim)
        self.Dense_1 = nn.Linear(mlp_dim, d)

    def forward(self, x, mask=None):
        y = self.MultiHeadAttention_0(_layer_norm(self.LayerNorm_0, x), mask)
        x = x + y
        y = _dense(self.Dense_0, _layer_norm(self.LayerNorm_1, x),
                   self.dtype)
        y = _dense(self.Dense_1, F.gelu(y, approximate="tanh"), self.dtype)
        return x + y


class BertEncoder(nn.Module):
    """Pre-LN BERT encoder with an MLM head; the flax model's arguments
    and defaults (BERT-base widths, bf16)."""

    def __init__(self, vocab_size: int = 30522, hidden: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype, self.num_layers = dtype, num_layers
        self.tok_emb = nn.Embedding(vocab_size, hidden)
        self.pos_emb = nn.Parameter(torch.zeros(max_len, hidden))
        for i in range(num_layers):
            setattr(self, f"EncoderLayer_{i}",
                    EncoderLayer(hidden, num_heads, mlp_dim, dtype))
        self.LayerNorm_0 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.mlm_head = nn.Linear(hidden, vocab_size)

    def init(self, seed: int = 0) -> "BertEncoder":
        """flax's initialisers from a ``torch.Generator`` seeded ``seed``:
        lecun-normal Dense kernels, token embeddings N(0, 1/hidden) (flax
        ``Embed``), positions N(0, 0.02), zero biases, unit LayerNorm
        scales.  Returns the module."""
        from .resnet import lecun_normal_
        g = torch.Generator(device=self.pos_emb.device)
        g.manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, g)
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            hidden = self.pos_emb.shape[1]
            self.tok_emb.weight.normal_(0.0, hidden ** -0.5, generator=g)
            self.pos_emb.normal_(0.0, 0.02, generator=g)
        return self

    def forward(self, token_ids, mask=None):
        """``token_ids`` [B, S] -> f32 logits [B, S, vocab]."""
        s = token_ids.shape[1]
        x = self.tok_emb(token_ids.long()).to(self.dtype)
        x = x + self.pos_emb[None, :s].to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"EncoderLayer_{i}")(x, mask)
        return _dense(self.mlm_head, _layer_norm(self.LayerNorm_0, x),
                      torch.float32)


def bert_base(**kw) -> BertEncoder:
    return BertEncoder(**kw)


def bert_tiny(**kw) -> BertEncoder:
    d = dict(vocab_size=1024, hidden=128, num_layers=2, num_heads=2,
             mlp_dim=512, max_len=128)
    d.update(kw)
    return BertEncoder(**d)
