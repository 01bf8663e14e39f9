"""GPT-style causal transformer LM (counterpart of kungfu_tpu/models/gpt.py).

Parameters are a plain dictionary with the JAX package's names and
layouts, so a JAX checkpoint or parameter tree carries over by name
(``convert.params_from_jax``, ``checkpoint.restore_npz_like``):

    wte [V, D] f32, optional wpe [max_seq, D] f32, lnf [D] f32,
    lm_head [D, V] f32, layers: [{ln1 [D], wq [D, H, Dh],
    wk/wv [D, KVH, Dh], wo [H, Dh, D], ln2 [D], wi [D, F] (gelu) or
    [D, 2, F] (swiglu), wm [F, D]}]

Numerics follow the JAX functions: activations in ``cfg.dtype``, norms and
softmax in f32, logits f32 from the f32 ``lm_head``.  What is ported is
the training forward (flash or dense attend, remat modes), the loss and
the plain decode loop (the serving engine's oracle); tensor and sequence
parallelism come with the parallel slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.flash_attention import _expand_kv_heads, flash_attention
from ..parallel.ring_attention import reference_attention


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq: int = 1024
    dtype: Any = torch.bfloat16
    # grouped-query attention: number of KV heads (None = n_heads)
    n_kv_heads: Optional[int] = None
    # rotary position embeddings instead of the learned wpe table
    rope: bool = False
    # dtype of the RoPE rotation math; None = the activation dtype
    rope_dtype: Any = None
    # "gelu" (GPT-2 style, tanh approximation as jax.nn.gelu) or
    # "swiglu" (wi holds gate and up projections as [D, 2, d_ff])
    mlp: str = "gelu"

    def __post_init__(self):
        if self.d_model % self.n_heads != 0:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        if self.n_kv_heads is not None and self.n_kv_heads <= 0:
            raise ValueError(f"n_kv_heads must be positive, "
                             f"got {self.n_kv_heads}")
        if self.n_heads % self.kv_heads != 0:
            raise ValueError(f"n_heads {self.n_heads} not divisible by "
                             f"n_kv_heads {self.kv_heads}")
        if self.rope and self.head_dim % 2 != 0:
            raise ValueError(f"RoPE needs an even head_dim, "
                             f"got {self.head_dim}")
        if self.mlp not in ("gelu", "swiglu"):
            raise ValueError(f"mlp must be 'gelu' or 'swiglu', "
                             f"got {self.mlp!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def kv_groups(self) -> int:
        return self.n_heads // self.kv_heads


# matmul weights: stored in the model dtype by cast_params; everything
# else (embeddings, norms, lm_head) stays f32 as in the JAX tree
_MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "wi", "wm")


def param_shapes(cfg: GPTConfig) -> Dict:
    """The parameter tree's shapes (the same nesting as the parameters)."""
    D, H, Dh, Fd, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                       cfg.vocab_size)
    Hkv = cfg.kv_heads
    layer = {"ln1": (D,), "wq": (D, H, Dh), "wk": (D, Hkv, Dh),
             "wv": (D, Hkv, Dh), "wo": (H, Dh, D), "ln2": (D,),
             "wi": (D, 2, Fd) if cfg.mlp == "swiglu" else (D, Fd),
             "wm": (Fd, D)}
    out = {"wte": (V, D), "layers": [dict(layer)
                                     for _ in range(cfg.n_layers)],
           "lnf": (D,), "lm_head": (D, V)}
    if not cfg.rope:
        out["wpe"] = (cfg.max_seq, D)
    return out


def init_params(gen: torch.Generator, cfg: GPTConfig) -> Dict:
    """f32 parameters drawn from ``gen`` on ``gen``'s device: normal
    weights scaled by 1/sqrt(fan_in), unit norms, wpe scaled by 0.1 (the
    JAX init's distribution; its bits differ)."""
    dev = gen.device

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) / math.sqrt(fan_in))

    shapes = param_shapes(cfg)
    layers: List[Dict] = []
    for lshapes in shapes["layers"]:
        layer = {}
        for name, shape in lshapes.items():
            if name in ("ln1", "ln2"):
                layer[name] = torch.ones(shape, device=dev)
            else:
                layer[name] = dense(shape, shape[0] if name != "wo"
                                    else cfg.d_model)
        layers.append(layer)
    out = {"wte": dense(shapes["wte"], cfg.d_model), "layers": layers,
           "lnf": torch.ones(shapes["lnf"], device=dev),
           "lm_head": dense(shapes["lm_head"], cfg.d_model)}
    if not cfg.rope:
        out["wpe"] = dense(shapes["wpe"], cfg.d_model) * 0.1
    return out


def cast_params(params: Dict, cfg: GPTConfig,
                device: Optional[torch.device] = None) -> Dict:
    """Move the tree to ``device`` and store the matmul weights once in
    the model dtype (the JAX functions cast them at every use; the cast
    is the same, so the numbers are too).  Embeddings, norms and the LM
    head stay f32."""
    def mv(t, dtype):
        return t.to(device=device if device is not None else t.device,
                    dtype=dtype)
    out = {k: mv(v, torch.float32) for k, v in params.items()
           if k != "layers"}
    out["layers"] = [{k: mv(v, cfg.dtype if k in _MATMUL_WEIGHTS
                           else torch.float32)
                      for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def embed(params, tokens, pos, cfg: GPTConfig):
    """Token (+ learned position, unless RoPE) embedding: gathers the f32
    tables, then casts.  Positions past the wpe table are clamped to its
    last row, as a JAX gather clamps (only discarded in-chunk decode
    steps reach them)."""
    x = params["wte"][tokens]
    if not cfg.rope:
        wpe = params["wpe"]
        pos = torch.as_tensor(pos, device=wpe.device)
        x = x + wpe[pos.clamp(max=wpe.shape[0] - 1)]
    return x.to(cfg.dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    """RMS layernorm in f32 (bias-free); multiplies by the f32 scale
    before casting back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _rope_rotate(t, pos, cfg: GPTConfig):
    """Split-half rotary embedding on [B, T, heads, Dh] with positions
    ``pos`` [T] or [B, T]: angles in f32, the rotation in ``rope_dtype``
    (default the activation dtype)."""
    half = cfg.head_dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=t.device) / half)
    ang = pos.float()[..., None] * freqs              # [(B,) T, half]
    rd = cfg.rope_dtype or t.dtype
    cos = torch.cos(ang)[..., None, :].to(rd)
    sin = torch.sin(ang)[..., None, :].to(rd)
    t1, t2 = t[..., :half].to(rd), t[..., half:].to(rd)
    return torch.cat([t1 * cos - t2 * sin,
                      t1 * sin + t2 * cos], dim=-1).to(t.dtype)


def _layer_qkv(layer, x, cfg: GPTConfig, pos=None):
    """ln1 + q/k/v projections; k/v come out with ``kv_heads`` heads.
    With RoPE, q and k are rotated by the global positions ``pos``."""
    h = rms_norm(x, layer["ln1"])
    q = torch.einsum("btd,dhk->bthk", h, layer["wq"].to(cfg.dtype))
    kk = torch.einsum("btd,dhk->bthk", h, layer["wk"].to(cfg.dtype))
    v = torch.einsum("btd,dhk->bthk", h, layer["wv"].to(cfg.dtype))
    if cfg.rope:
        if pos is None:
            raise ValueError("RoPE model needs positions in _layer_qkv")
        q = _rope_rotate(q, pos, cfg)
        kk = _rope_rotate(kk, pos, cfg)
    return q, kk, v


def _expand_kv(t, cfg: GPTConfig):
    """[B, T, kv_heads, Dh] -> [B, T, n_heads, Dh]."""
    return _expand_kv_heads(t, cfg.kv_groups)


def _dense_ffn(layer, h, cfg: GPTConfig):
    """Post-norm activations -> FFN delta (no residual add)."""
    if cfg.mlp == "swiglu":
        wi = layer["wi"].to(cfg.dtype)              # [D, 2, F]
        fl = wi.shape[2]
        u = h @ wi.reshape(wi.shape[0], 2 * fl)     # one packed matmul
        u = F.silu(u[..., :fl]) * u[..., fl:]
    else:
        u = F.gelu(h @ layer["wi"].to(cfg.dtype), approximate="tanh")
    return u @ layer["wm"].to(cfg.dtype)


def _layer_finish(layer, x, o, cfg: GPTConfig, remat_ffn: bool = False):
    """Attention output projection + residual + FFN; with ``remat_ffn``
    the norm + FFN sub-block is recomputed in the backward."""
    o = torch.einsum("bthk,hkd->btd", o, layer["wo"].to(cfg.dtype))
    x = x + o

    def norm_ffn(x):
        return _dense_ffn(layer, rms_norm(x, layer["ln2"]), cfg)

    if remat_ffn:
        norm_ffn = _checkpoint(norm_ffn)
    return x + norm_ffn(x)


def _attend(q, kk, v, attn: str, kv_groups: int = 1):
    """``kk``/``v`` arrive compact (kv_heads).  "flash": the flash
    kernels (K1-K4), which read the compact KV heads directly; "dense":
    the f32 oracle on expanded heads."""
    if attn == "flash":
        return flash_attention(q, kk, v, causal=True, kv_groups=kv_groups)
    if attn == "dense":
        return reference_attention(q, _expand_kv_heads(kk, kv_groups),
                                   _expand_kv_heads(v, kv_groups),
                                   causal=True)
    raise ValueError(f"unknown or unported attention mode {attn!r}")


def _checkpoint(fn):
    """``fn`` rematerialised in the backward (non-reentrant
    ``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``)."""
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False)


def apply_layer(layer, x, cfg: GPTConfig, *, attn: str = "dense",
                pos=None, remat_ffn: bool = False,
                remat_around_attn: bool = False):
    """One transformer block on ``x`` [B, T, D]; ``pos`` [T] the token
    positions (default arange).

    ``remat_ffn`` recomputes the norm + FFN sub-block in the backward.
    ``remat_around_attn`` is selective remat: the qkv projections and the
    output-projection + FFN tail each sit in their own checkpoint region
    while the attention call stays OUTSIDE every region, so its residuals
    (q, compact k/v, out, lse) are saved and the backward never re-runs
    the attention forward."""
    if pos is None:
        pos = torch.arange(x.shape[1], device=x.device)

    def qkv_fn(layer, x):
        return _layer_qkv(layer, x, cfg, pos=pos)

    def finish(layer, x, o):
        return _layer_finish(layer, x, o, cfg, remat_ffn)

    if remat_around_attn:
        qkv_fn, finish = _checkpoint(qkv_fn), _checkpoint(finish)
    q, kk, v = qkv_fn(layer, x)
    o = _attend(q, kk, v, attn, kv_groups=cfg.kv_groups)
    return finish(layer, x, o)


_REMAT_MODES = (False, None, "", "none", True, "full", "ffn", "attn")


def forward_features(params, tokens, cfg: GPTConfig, attn: str = "auto",
                     remat=False):
    """Transformer stack -> post-norm features [B, T, D] (everything but
    the LM head); feed them to ``ops.chunked_ce.chunked_cross_entropy``
    to train without [B, T, V] logits.

    ``attn``: "flash" (the CUDA kernels; their plain version on a CPU
    tensor) | "dense"; "auto" = flash on a CUDA tensor, dense on a CPU
    one.  ``remat``: False/"none" | "full"/True (each layer recomputed
    in the backward; the flash forward then runs twice per layer) |
    "ffn" | "attn" (see :func:`apply_layer`)."""
    if remat not in _REMAT_MODES:
        raise ValueError(f"unknown remat mode {remat!r}")
    if attn == "auto":
        attn = "flash" if tokens.device.type == "cuda" else "dense"
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device)
    x = embed(params, tokens, pos[None], cfg)

    def layer_fn(layer, x):
        return apply_layer(layer, x, cfg, attn=attn, pos=pos,
                           remat_ffn=(remat == "ffn"),
                           remat_around_attn=(remat == "attn"))

    if remat in (True, "full"):
        layer_fn = _checkpoint(layer_fn)
    for layer in params["layers"]:
        x = layer_fn(layer, x)
    return rms_norm(x, params["lnf"])


def forward_local(params, tokens, cfg: GPTConfig, attn: str = "auto",
                  remat=False):
    """:func:`forward_features` + LM head -> f32 logits [B, T, V]."""
    x = forward_features(params, tokens, cfg, attn=attn, remat=remat)
    return torch.einsum("btd,dv->btv", x.float(), params["lm_head"].float())


def parallel_cross_entropy(logits, targets):
    """Token NLL [B, T] from f32 logits [B, T, V] (the unsharded case of
    the JAX function: the max is a stability shift with its gradient
    stopped)."""
    m = logits.detach().amax(dim=-1)
    denom = torch.exp(logits - m[..., None]).sum(dim=-1)
    picked = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return m + torch.log(denom) - picked


def forward(params, tokens, cfg: GPTConfig):
    """Single-device forward -> f32 logits [B, T, V] (the oracle)."""
    return forward_local(params, tokens, cfg, attn="dense")


def loss_fn(params, tokens, targets, cfg: GPTConfig):
    """Mean token NLL (the oracle)."""
    return parallel_cross_entropy(forward(params, tokens, cfg),
                                  targets).mean()


# --------------------------------------------------------------- generation
def init_kv_cache(cfg: GPTConfig, batch: int, max_len: Optional[int] = None,
                  device=None):
    """Per-layer KV cache: k/v [B, max_len, kv_heads, Dh] in the model
    dtype."""
    L = max_len or cfg.max_seq
    if L > cfg.max_seq and not cfg.rope:
        raise ValueError(f"cache length {L} exceeds max_seq {cfg.max_seq} "
                         f"(wpe has no embeddings past it; RoPE models "
                         f"have no such bound)")
    shape = (batch, L, cfg.kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _decode_attend(q, kc, vc, pos):
    """q [B, Q, H, Dh] vs cache [B, L, H, Dh] (already GQA-expanded),
    in f32; keys past ``pos`` masked with -1e30.  ``pos`` is an int (the
    whole batch at one depth) or [B] (each row at its own depth)."""
    L = kc.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     kc.float()) / math.sqrt(q.shape[-1])
    pos = torch.atleast_1d(torch.as_tensor(pos, device=q.device))
    mask = (torch.arange(L, device=q.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vc.float()).to(q.dtype)


def _decode_hidden(params, cfg: GPTConfig, cache, pos: int, token):
    """One incremental step through the layer stack (no lm_head); writes
    this position's K/V into ``cache`` in place.  Returns x [B, 1, D]."""
    x = embed(params, token[:, None], pos, cfg)               # [B, 1, D]
    pos1 = torch.tensor([pos], device=x.device)
    for layer, kv in zip(params["layers"], cache):
        q, kk, v = _layer_qkv(layer, x, cfg, pos=pos1)
        kv["k"][:, pos] = kk[:, 0]
        kv["v"][:, pos] = v[:, 0]
        o = _decode_attend(q, _expand_kv(kv["k"], cfg),
                           _expand_kv(kv["v"], cfg), pos)
        x = _layer_finish(layer, x, o, cfg)
    return rms_norm(x, params["lnf"])


def _head(params, x):
    """lm_head on [B, 1, D] -> [B, V] f32 logits."""
    return torch.einsum("btd,dv->btv", x.float(), params["lm_head"])[:, 0]


@torch.no_grad()
def decode_step(params, cfg: GPTConfig, cache, pos: int, token):
    """One incremental decode step: ``token`` [B] at position ``pos``.
    Returns logits [B, V]; ``cache`` is updated in place."""
    return _head(params, _decode_hidden(params, cfg, cache, pos, token))


@torch.no_grad()
def prefill(params, cfg: GPTConfig, cache, tokens):
    """Fill the cache from a prompt [B, T] by T incremental steps;
    returns the last position's logits.  The lm_head runs once."""
    x = None
    for t in range(tokens.shape[1]):
        x = _decode_hidden(params, cfg, cache, t, tokens[:, t])
    return _head(params, x)


@torch.no_grad()
def generate(params, cfg: GPTConfig, prompt, n_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None):
    """Autoregressive generation (greedy, or sampled from ``generator``
    when temperature > 0).  ``prompt`` [B, T] int; returns [B, n_tokens]
    int32 on the prompt's device."""
    B, T = prompt.shape
    cache = init_kv_cache(cfg, B, max_len or cfg.max_seq,
                          device=prompt.device)
    L = cache[0]["k"].shape[1]
    if T + n_tokens > L:
        raise ValueError(f"prompt {T} + {n_tokens} new tokens exceeds "
                         f"cache length {L}")
    logits = prefill(params, cfg, cache, prompt)
    toks = []
    for i in range(n_tokens):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = tok.to(torch.int32)
        toks.append(tok)
        if i + 1 < n_tokens:
            logits = _head(params, _decode_hidden(params, cfg, cache,
                                                  T + i, tok))
    return torch.stack(toks, dim=1)
