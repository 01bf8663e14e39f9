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
the training forward (flash or dense attend, remat modes), the loss, the
plain decode loop (the serving engine's oracle), tensor and sequence
parallelism in training, and tensor parallelism in decode.

Parallelism: where a JAX function takes the mesh axis names ``tp_axis``
and ``sp_axis`` inside ``shard_map``, these take the process groups
``tp_group`` and ``sp_group`` (a ``comm.mesh.ProcessMesh``'s).  Under tp
each rank holds the slices :func:`param_specs` names (heads, FFN features,
vocabulary); a replicated activation enters a sharded product through
``copy_to_group`` and the partial products leave through
``reduce_from_group``, which places the all-reduces where JAX's psums and
their transposes fall.  Under sp each rank holds a block of the sequence
and rotates RoPE by its global positions.  Decode is forward only: its
partial products are completed by plain all-reduces (:func:`_tp_sum`) and
its vocabulary-sharded logits by one all-gather (:func:`tp_head`), with
no autograd function in between.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from ..comm.collectives import copy_to_group, pmax, reduce_from_group
from ..ops.flash_attention import _expand_kv_heads, flash_attention
from ..parallel.ring_attention import (reference_attention, ring_attention,
                                       ring_flash_attention,
                                       ulysses_attention)


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


def param_specs(cfg: GPTConfig) -> Dict:
    """The dimension each parameter splits on over the tp ranks, or None
    for a replicated one, in the parameter tree's nesting (JAX's
    ``PartitionSpec`` tree: q/k/v on their heads, the attention output on
    its heads, the FFN on its features, the LM head on the vocabulary)."""
    def layer():
        return {"ln1": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
                "ln2": None, "wi": 2 if cfg.mlp == "swiglu" else 1,
                "wm": 0}
    out = {"wte": None, "layers": [layer() for _ in range(cfg.n_layers)],
           "lnf": None, "lm_head": 1}
    if not cfg.rope:
        out["wpe"] = None
    return out


def validate_tp(cfg: GPTConfig, ntp: int) -> None:
    """Every dimension :func:`param_specs` shards over tp must divide by
    the rank count."""
    for what, val in (("n_heads", cfg.n_heads), ("kv_heads", cfg.kv_heads),
                      ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)):
        if val % ntp != 0:
            raise ValueError(f"{what}={val} not divisible by {ntp} "
                             f"tensor-parallel ranks")


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
    head stay f32.  An int8 weight (``ops.quant.QuantizedTensor``, made
    from the caller's f32 tree) moves as it is: casting first would
    quantize other values."""
    def mv(t, dtype):
        if not isinstance(t, torch.Tensor):
            return t.to(device) if device is not None else t
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


def _layer_qkv(layer, x, cfg: GPTConfig, pos=None, tp_group=None):
    """ln1 + q/k/v projections; k/v come out with ``kv_heads`` heads (the
    rank's heads under tp).  With RoPE, q and k are rotated by the global
    positions ``pos``."""
    h = rms_norm(x, layer["ln1"])
    if tp_group is not None:
        h = copy_to_group(h, tp_group)
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


def _dense_ffn(layer, h, cfg: GPTConfig, tp_group=None):
    """Post-norm activations -> FFN delta (no residual add).  Under tp
    the rank's features, and one all-reduce of the delta."""
    if tp_group is not None:
        h = copy_to_group(h, tp_group)
    if cfg.mlp == "swiglu":
        wi = layer["wi"].to(cfg.dtype)              # [D, 2, F]
        fl = wi.shape[2]
        u = h @ wi.reshape(wi.shape[0], 2 * fl)     # one packed matmul
        u = F.silu(u[..., :fl]) * u[..., fl:]
    else:
        u = F.gelu(h @ layer["wi"].to(cfg.dtype), approximate="tanh")
    m = u @ layer["wm"].to(cfg.dtype)
    if tp_group is not None:
        m = reduce_from_group(m, tp_group)
    return m


def _layer_finish(layer, x, o, cfg: GPTConfig, remat_ffn: bool = False,
                  tp_group=None):
    """Attention output projection + residual + FFN; with ``remat_ffn``
    the norm + FFN sub-block is recomputed in the backward."""
    o = torch.einsum("bthk,hkd->btd", o, layer["wo"].to(cfg.dtype))
    if tp_group is not None:
        o = reduce_from_group(o, tp_group)
    x = x + o

    def norm_ffn(x):
        return _dense_ffn(layer, rms_norm(x, layer["ln2"]), cfg, tp_group)

    if remat_ffn:
        norm_ffn = _checkpoint(norm_ffn)
    return x + norm_ffn(x)


# the attention modes that attend over the sequence shards of an sp group
SP_ATTN_MODES = ("ring", "ring_flash", "ulysses")


def _attend(q, kk, v, attn: str, kv_groups: int = 1, sp_group=None):
    """``kk``/``v`` arrive compact (kv_heads).  "flash": the flash
    kernels (K1-K4), which read the compact KV heads directly; "dense":
    the f32 oracle on expanded heads; "ring", "ring_flash" (the flash
    kernels on the diagonal and past chunks) and "ulysses" attend over the sequence shards
    of ``sp_group`` with the compact KV heads in transit."""
    if attn in SP_ATTN_MODES and sp_group is None:
        raise ValueError(f"attn={attn!r} needs a sequence-parallel group")
    if attn == "ring":
        return ring_attention(q, kk, v, sp_group, causal=True,
                              kv_groups=kv_groups)
    if attn == "ring_flash":
        return ring_flash_attention(q, kk, v, sp_group, causal=True,
                                    kv_groups=kv_groups)
    if attn == "ulysses":
        return ulysses_attention(q, kk, v, sp_group, causal=True,
                                 kv_groups=kv_groups)
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
                remat_around_attn: bool = False, tp_group=None,
                sp_group=None):
    """One transformer block on (this rank's) ``x`` [B, T, D]; ``pos``
    [T] the GLOBAL token positions, which a sequence-sharded RoPE model
    must give (default arange, the unsharded case).

    ``remat_ffn`` recomputes the norm + FFN sub-block in the backward.
    ``remat_around_attn`` is selective remat: the qkv projections and the
    output-projection + FFN tail each sit in their own checkpoint region
    while the attention call stays OUTSIDE every region, so its residuals
    (q, compact k/v, out, lse) are saved and the backward never re-runs
    the attention forward."""
    if pos is None:
        if cfg.rope and sp_group is not None:
            raise ValueError("RoPE under sequence parallelism needs "
                             "explicit global positions (pos)")
        pos = torch.arange(x.shape[1], device=x.device)

    def qkv_fn(layer, x):
        return _layer_qkv(layer, x, cfg, pos=pos, tp_group=tp_group)

    def finish(layer, x, o):
        return _layer_finish(layer, x, o, cfg, remat_ffn, tp_group)

    if remat_around_attn:
        qkv_fn, finish = _checkpoint(qkv_fn), _checkpoint(finish)
    q, kk, v = qkv_fn(layer, x)
    o = _attend(q, kk, v, attn, kv_groups=cfg.kv_groups, sp_group=sp_group)
    return finish(layer, x, o)


_REMAT_MODES = (False, None, "", "none", True, "full", "ffn", "attn")


def _global_positions(T: int, sp_group, device):
    """This rank's positions in the global sequence: its block of the
    rank-order concatenation, offset by rank x T_local under sp."""
    offset = dist.get_rank(sp_group) * T if sp_group is not None else 0
    return offset + torch.arange(T, device=device)


def forward_features(params, tokens, cfg: GPTConfig, attn: str = "auto",
                     remat=False, tp_group=None, sp_group=None):
    """Transformer stack -> post-norm features [B, T, D] (everything but
    the LM head); feed them to ``ops.chunked_ce.chunked_cross_entropy``
    to train without [B, T, V] logits (unsharded head), or under tp
    to :func:`forward_local`'s vocab-sharded logits and
    :func:`parallel_cross_entropy`.

    ``tokens`` [B_local, T_local]: under ``sp_group`` the global sequence
    is the rank-order concatenation of the shards; under ``tp_group`` the
    parameters hold this rank's slices (:func:`param_specs`).

    ``attn``: "flash" (the CUDA kernels; their plain version on a CPU
    tensor) | "dense" | "ring" | "ring_flash" | "ulysses" (the last three
    need ``sp_group``); "auto" = ring_flash under sp on a CUDA tensor,
    ring under sp on a CPU one, else flash on a CUDA tensor, dense on a
    CPU one.  ``remat``: False/"none" | "full"/True (each layer
    recomputed in the backward; the flash forward then runs twice per
    layer) | "ffn" | "attn" (see :func:`apply_layer`)."""
    if remat not in _REMAT_MODES:
        raise ValueError(f"unknown remat mode {remat!r}")
    cuda = tokens.device.type == "cuda"
    if attn == "auto":
        if sp_group is not None:
            attn = "ring_flash" if cuda else "ring"
        else:
            attn = "flash" if cuda else "dense"
    T = tokens.shape[1]
    pos = _global_positions(T, sp_group, tokens.device)
    x = embed(params, tokens, pos[None], cfg)

    def layer_fn(layer, x):
        return apply_layer(layer, x, cfg, attn=attn, pos=pos,
                           remat_ffn=(remat == "ffn"),
                           remat_around_attn=(remat == "attn"),
                           tp_group=tp_group, sp_group=sp_group)

    if remat in (True, "full"):
        layer_fn = _checkpoint(layer_fn)
    for layer in params["layers"]:
        x = layer_fn(layer, x)
    return rms_norm(x, params["lnf"])


def forward_local(params, tokens, cfg: GPTConfig, attn: str = "auto",
                  remat=False, tp_group=None, sp_group=None):
    """:func:`forward_features` + LM head -> f32 logits [B, T, V]
    (vocab-sharded, [B, T, V / tp], under ``tp_group``)."""
    x = forward_features(params, tokens, cfg, attn=attn, remat=remat,
                         tp_group=tp_group, sp_group=sp_group).float()
    if tp_group is not None:
        x = copy_to_group(x, tp_group)
    return torch.einsum("btd,dv->btv", x, params["lm_head"].float())


def parallel_cross_entropy(logits, targets, tp_group=None):
    """Token NLL [B, T] from f32 logits [B, T, V_local] and GLOBAL target
    ids [B, T].  The max is a stability shift taken of stopped logits
    (one ``pmax`` over ``tp_group``); the normaliser and the target's
    logit are assembled with two all-reduces whose gradient is the
    identity (every tp rank backpropagates the same loss).  Logits are
    never gathered (Megatron's parallel cross-entropy)."""
    v_local = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    if tp_group is not None:
        m = pmax(m, tp_group)
    denom = torch.exp(logits - m[..., None]).sum(dim=-1)
    lo = dist.get_rank(tp_group) * v_local if tp_group is not None else 0
    local_t = targets.long() - lo
    in_range = (local_t >= 0) & (local_t < v_local)
    safe = local_t.clamp(0, v_local - 1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    picked = torch.where(in_range, picked, 0.0)
    if tp_group is not None:
        denom = reduce_from_group(denom, tp_group)
        picked = reduce_from_group(picked, tp_group)
    return m + torch.log(denom) - picked


def forward(params, tokens, cfg: GPTConfig):
    """Single-device forward -> f32 logits [B, T, V] (the oracle)."""
    return forward_local(params, tokens, cfg, attn="dense")


def loss_fn(params, tokens, targets, cfg: GPTConfig):
    """Mean token NLL (the oracle)."""
    return parallel_cross_entropy(forward(params, tokens, cfg),
                                  targets).mean()


# --------------------------------------------------------------- generation
def _check_cache_len(cfg: GPTConfig, L: int) -> None:
    if L > cfg.max_seq and not cfg.rope:
        raise ValueError(f"cache length {L} exceeds max_seq {cfg.max_seq} "
                         f"(wpe has no embeddings past it; RoPE models "
                         f"have no such bound)")


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: Optional[int] = None,
                  device=None, tp: int = 1):
    """Per-layer KV cache: k/v [B, max_len, kv_heads / tp, Dh] in the model
    dtype (a tp rank holds its shard of the KV heads)."""
    L = max_len or cfg.max_seq
    _check_cache_len(cfg, L)
    validate_tp(cfg, tp)
    shape = (batch, L, cfg.kv_heads // tp, cfg.head_dim)
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


def _tp_sum(t, tp_group):
    """Complete a partial product over ``tp_group`` in place: one plain
    all-reduce (sum), forward only (the decode programs' ``lax.psum``)."""
    dist.all_reduce(t, group=tp_group)
    return t


def _tp_gather(t, tp_group):
    """Join each rank's block of the last axis in rank order: one
    all-gather, forward only (``lax.all_gather(..., tiled=True)``)."""
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(tp_group))]
    dist.all_gather(parts, t.contiguous(), group=tp_group)
    return torch.cat(parts, dim=-1)


def _decode_finish(layer, x, o, cfg: GPTConfig, psum=None):
    """:func:`_layer_finish` for decode: forward only, and under tp
    ``psum(t)`` completes the rank's partial attention-output and FFN
    products in place (JAX's psums in ``_layer_finish`` and
    ``_dense_ffn``); the same arithmetic without it."""
    a = torch.einsum("bthk,hkd->btd", o, layer["wo"].to(cfg.dtype))
    x = x + (a if psum is None else psum(a))
    m = _dense_ffn(layer, rms_norm(x, layer["ln2"]), cfg)
    return x + (m if psum is None else psum(m))


def _decode_hidden(params, cfg: GPTConfig, cache, pos: int, token,
                   tp_group=None):
    """One incremental step through the layer stack (no lm_head); writes
    this position's K/V into ``cache`` in place.  Returns x [B, 1, D].
    Under ``tp_group`` the parameters and the cache hold the rank's head
    shard and each layer's partial products are summed over the group,
    so x is the same on every rank."""
    psum = (None if tp_group is None
            else lambda t: _tp_sum(t, tp_group))
    x = embed(params, token[:, None], pos, cfg)               # [B, 1, D]
    pos1 = torch.tensor([pos], device=x.device)
    for layer, kv in zip(params["layers"], cache):
        q, kk, v = _layer_qkv(layer, x, cfg, pos=pos1)
        kv["k"][:, pos] = kk[:, 0]
        kv["v"][:, pos] = v[:, 0]
        o = _decode_attend(q, _expand_kv(kv["k"], cfg),
                           _expand_kv(kv["v"], cfg), pos)
        x = _decode_finish(layer, x, o, cfg, psum)
    return rms_norm(x, params["lnf"])


def _head(params, x):
    """lm_head on [B, 1, D] -> [B, V] f32 logits (a dequantized bf16
    lm_head is widened, as the JAX einsum promotes it)."""
    return torch.einsum("btd,dv->btv", x.float(),
                        params["lm_head"].float())[:, 0]


def tp_head(params, x, tp_group=None):
    """f32 logits [B, V] from x [B, 1, D] under optional tensor
    parallelism: the rank's vocabulary block (lm_head splits on its
    columns, :func:`param_specs`) is all-gathered over ``tp_group`` in
    rank order, so every rank holds the same logits and picks the same
    token.  The one tp logits head of every decode path (the serving
    engine, :func:`generate` under tp)."""
    local = _head(params, x)
    return local if tp_group is None else _tp_gather(local, tp_group)


@torch.no_grad()
def decode_step(params, cfg: GPTConfig, cache, pos: int, token):
    """One incremental decode step: ``token`` [B] at position ``pos``.
    Returns logits [B, V]; ``cache`` is updated in place."""
    return _head(params, _decode_hidden(params, cfg, cache, pos, token))


@torch.no_grad()
def prefill(params, cfg: GPTConfig, cache, tokens, tp_group=None,
            head=None):
    """Fill the cache from a prompt [B, T] by T incremental steps;
    returns the last position's logits.  The lm_head runs once.
    ``head(x)`` replaces the logits head (under tp, :func:`tp_head`)."""
    x = None
    for t in range(tokens.shape[1]):
        x = _decode_hidden(params, cfg, cache, t, tokens[:, t], tp_group)
    return (head or (lambda x: _head(params, x)))(x)


@torch.no_grad()
def generate(params, cfg: GPTConfig, prompt, n_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None, cache=None, tp_group=None,
             head=None):
    """Autoregressive generation (greedy, or sampled from ``generator``
    when temperature > 0).  ``prompt`` [B, T] int; returns [B, n_tokens]
    int32 on the prompt's device.

    The one decode loop: tensor-parallel generation
    (``parallel.threed.make_tp_generate``) passes the rank's ``cache``
    shard, ``tp_group`` and the gathered ``head``."""
    B, T = prompt.shape
    if cache is None:
        cache = init_kv_cache(cfg, B, max_len or cfg.max_seq,
                              device=prompt.device)
    L = cache[0]["k"].shape[1]
    _check_cache_len(cfg, L)
    if T + n_tokens > L:
        raise ValueError(f"prompt {T} + {n_tokens} new tokens exceeds "
                         f"cache length {L}")
    head = head or (lambda x: _head(params, x))
    logits = prefill(params, cfg, cache, prompt, tp_group, head)
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
            logits = head(_decode_hidden(params, cfg, cache, T + i, tok,
                                         tp_group))
    return torch.stack(toks, dim=1)
