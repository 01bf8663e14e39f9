"""Flash attention, forward and backward (counterpart of
kungfu_tpu/ops/flash_attention.py).

The JAX package runs four Pallas TPU kernels; here they are CUDA C++
kernels for Hopper in ``csrc/flash_attention.cu``, built with nvcc at
first use and called through ctypes (``_build.py``):

* K1 :func:`flash_forward`  -- out and the natural-log lse  (``_fa_kernel``)
* K2 :func:`flash_delta`    -- delta = rowsum(dO * O) - dlse (``_fa_delta_kernel``)
* K3 :func:`flash_bwd_dq`   -- dq                           (``_fa_bwd_dq_kernel``)
* K4 :func:`flash_bwd_dkv`  -- compact dk, dv                (``_fa_bwd_dkv_kernel``)

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain PyTorch version for CPU tensors; ``launches`` counts kernel
launches per kernel and nothing else.  :class:`_FlashAttention` chains
them into an autograd function; :func:`flash_attention` and
:func:`flash_attention_with_lse` are the public API with the JAX
signatures.  :func:`flash_attention_ref` is the differentiable plain
version (the counterpart of ``_jnp_flash``).

Layout is the JAX package's, [B, T, heads, D], read by strides: no
transposes.  ``k``/``v`` arrive compact under GQA ([B, Tk, H / g, D]);
query head ``h`` reads KV head ``h // g`` (``repeat_interleave``).  The
causal mask is ``qpos >= kpos`` counted from 0, also when Tq != Tk.
The kernels take head_dim 64 or 128 and any T (the ragged edge is
masked, so the TPU's multiple-of-8 block rule does not apply).  The
block-size arguments of the JAX API are accepted and do not change the
result: the CUDA tiles are fixed (64 keys by 64 query rows a warpgroup).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
_LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)

# kernel launches since the last reset (each wrapper adds one per launch)
launches = {"fa_fwd": 0, "fa_delta": 0, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _expand_kv_heads(t, kv_groups: int):
    """[B, T, Hkv, D] -> [B, T, Hkv*g, D] (repeat: query head h reads KV
    head h // g)."""
    return t if kv_groups == 1 else t.repeat_interleave(kv_groups, dim=2)


def _compact_kv_grad(dt, kv_groups: int):
    """Adjoint of _expand_kv_heads: sum each group's gradients."""
    if kv_groups == 1:
        return dt
    B, T, H, D = dt.shape
    return dt.reshape(B, T, H // kv_groups, kv_groups, D).sum(dim=3)


def _causal_mask(Tq: int, Tk: int, device):
    return (torch.arange(Tq, device=device)[:, None]
            >= torch.arange(Tk, device=device)[None, :])


def flash_attention_ref(q, k, v, causal: bool = False):
    """Differentiable plain version, ``k``/``v`` already expanded to H
    heads: (out [B, T, H, D] in q's dtype, lse [B, H, T] f32).  f32
    scores, masked to -1e30, a row max with its gradient stopped."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float()) / math.sqrt(q.shape[-1])
    if causal:
        s = torch.where(_causal_mask(s.shape[2], s.shape[3], s.device),
                        s, NEG_INF)
    m = s.amax(dim=-1).detach()
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l[..., None], v.float())
    return out.to(q.dtype), m + torch.log(l)


# --------------------------------------------------- plain kernel versions
def _delta_plain(out, dout, dlse=None):
    d = (out.float() * dout.float()).sum(dim=-1).permute(0, 2, 1)
    if dlse is not None:
        d = d - dlse.float()
    return d.contiguous()


def _p_ds_plain(q, k, v, dout, lse, delta, causal, kv_groups):
    """The backward's recomputation, as the kernels do it (base 2):
    p = exp2(s * scale * log2e - lse * log2e), ds = p (dp - delta) scale,
    with [B, H, Tq, Tk] f32 tiles and k/v expanded."""
    ke = _expand_kv_heads(k, kv_groups).float()
    ve = _expand_kv_heads(v, kv_groups).float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke) * (scale * _LOG2E)
    if causal:
        s = torch.where(_causal_mask(s.shape[2], s.shape[3], s.device),
                        s, NEG_INF)
    p = torch.exp2(s - lse[..., None] * _LOG2E)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), ve)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, ke


def _dq_plain(q, k, v, dout, lse, delta, causal, kv_groups):
    _, ds, ke = _p_ds_plain(q, k, v, dout, lse, delta, causal, kv_groups)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), ke)
    return dq.to(q.dtype)


def _dkv_plain(q, k, v, dout, lse, delta, causal, kv_groups):
    p, ds, _ = _p_ds_plain(q, k, v, dout, lse, delta, causal, kv_groups)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(),
                      dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (_compact_kv_grad(dk, kv_groups).to(k.dtype),
            _compact_kv_grad(dv, kv_groups).to(v.dtype))


# ----------------------------------------------------------- kernel side
def _strides(t):
    """(batch, time, head) element strides as a C array."""
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def _kernel_layout_ok(t) -> bool:
    """A contiguous last dimension and 16-byte aligned rows: what the
    kernels' 16-byte staging loads need (any other strides are fine)."""
    isz = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any((s * isz) % 16 for s in t.stride()[:3]))


def _check(name: str, tensors: dict, dtype=None):
    """What every kernel needs: one CUDA device, bf16 or f32 throughout,
    head_dim 64 or 128, a contiguous last dimension and 16-byte aligned
    rows (the kernels stage rows with 16-byte loads)."""
    ref = next(iter(tensors.values()))
    dtype = dtype or ref.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} is not float32 or bfloat16")
    for key, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, expected "
                             f"{ref.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} dtype {t.dtype}, expected "
                            f"{dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {key} must be 4-D with head_dim "
                             f"last, got shape {tuple(t.shape)}")
        if t.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"{name}: head_dim {t.shape[-1]} not in "
                             f"{HEAD_DIMS}")
        if not _kernel_layout_ok(t):
            raise ValueError(f"{name}: {key} needs a contiguous last "
                             f"dimension and 16-byte aligned rows, got "
                             f"strides {t.stride()}")


def _check_rows(name: str, t, B: int, H: int, T: int, device):
    if (t.dtype != torch.float32 or t.device != device
            or tuple(t.shape) != (B, H, T) or not t.is_contiguous()):
        raise ValueError(f"{name}: row statistic must be contiguous f32 "
                         f"[{B}, {H}, {T}] on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _shapes(q, k, v, kv_groups: int):
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if k.shape[2] * kv_groups != H:
        raise ValueError(f"flash_attention: {H} query heads != "
                         f"{k.shape[2]} KV heads x kv_groups {kv_groups}")
    return B, Tq, H, D, k.shape[1], k.shape[2]


def _device_kind(t, name):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def _run(fn, *args):
    from . import _build
    lib = _build.load("flash_attention")
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {rc}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward(q, k, v, causal: bool = False, kv_groups: int = 1):
    """K1: (out [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32)."""
    B, Tq, H, D, Tk, KVH = _shapes(q, k, v, kv_groups)
    if _device_kind(q, "flash_forward") == "cpu":
        with torch.no_grad():
            return flash_attention_ref(q, _expand_kv_heads(k, kv_groups),
                                       _expand_kv_heads(v, kv_groups),
                                       causal)
    _check("flash_forward", {"q": q, "k": k, "v": v})
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _run("kft_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), lse.data_ptr(), _strides(q), _strides(k),
             _strides(v), B, H, KVH, Tq, Tk, D, _DTYPE_CODES[q.dtype],
             int(causal), 1.0 / math.sqrt(D), _stream(q))
    launches["fa_fwd"] += 1
    return out, lse


def flash_delta(out, dout, dlse: Optional[torch.Tensor] = None):
    """K2: delta [B, H, T] f32 = rowsum(dO * O) - dlse."""
    if out.shape != dout.shape:
        raise ValueError(f"flash_delta: out {tuple(out.shape)} != dout "
                         f"{tuple(dout.shape)}")
    if _device_kind(out, "flash_delta") == "cpu":
        return _delta_plain(out, dout, dlse)
    _check("flash_delta", {"out": out, "dout": dout})
    B, T, H, D = out.shape
    if dlse is not None:
        _check_rows("flash_delta", dlse, B, H, T, out.device)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=out.device)
    with torch.cuda.device(out.device):
        _run("kft_flash_delta", out.data_ptr(), dout.data_ptr(),
             dlse.data_ptr() if dlse is not None else None,
             delta.data_ptr(), _strides(out), _strides(dout), B, H, T, D,
             _DTYPE_CODES[out.dtype], _stream(out))
    launches["fa_delta"] += 1
    return delta


def _bwd_checks(name, q, k, v, dout, lse, delta, kv_groups):
    B, Tq, H, D, Tk, KVH = _shapes(q, k, v, kv_groups)
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} != q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cuda":
        _check(name, {"q": q, "k": k, "v": v, "dout": dout})
        _check_rows(name, lse, B, H, Tq, q.device)
        _check_rows(name, delta, B, H, Tq, q.device)
    return B, Tq, H, D, Tk, KVH


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = False,
                 kv_groups: int = 1):
    """K3: dq [B, Tq, H, D] in q's dtype."""
    B, Tq, H, D, Tk, KVH = _bwd_checks("flash_bwd_dq", q, k, v, dout, lse,
                                       delta, kv_groups)
    if _device_kind(q, "flash_bwd_dq") == "cpu":
        return _dq_plain(q, k, v, dout, lse, delta, causal, kv_groups)
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _run("kft_flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), _strides(q), _strides(k), _strides(v),
             _strides(dout), B, H, KVH, Tq, Tk, D, _DTYPE_CODES[q.dtype],
             int(causal), 1.0 / math.sqrt(D), _stream(q))
    launches["fa_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = False,
                  kv_groups: int = 1):
    """K4: compact (dk, dv) [B, Tk, H / g, D] in k's dtype."""
    B, Tq, H, D, Tk, KVH = _bwd_checks("flash_bwd_dkv", q, k, v, dout, lse,
                                       delta, kv_groups)
    if _device_kind(q, "flash_bwd_dkv") == "cpu":
        return _dkv_plain(q, k, v, dout, lse, delta, causal, kv_groups)
    dk = torch.empty((B, Tk, KVH, D), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        _run("kft_flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), _strides(q), _strides(k),
             _strides(v), _strides(dout), B, H, KVH, Tq, Tk, D,
             _DTYPE_CODES[q.dtype], int(causal), 1.0 / math.sqrt(D),
             _stream(q))
    launches["fa_bwd_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward (saving q, compact k/v, out and lse, the ``_fa_fwd``
    residuals); K2, K3, K4 backward, returning compact dk/dv.  Both
    outputs are differentiable: the lse cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_groups: int):
        out, lse = flash_forward(q, k, v, causal, kv_groups)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kv_groups = causal, kv_groups
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        if dout.is_cuda and not _kernel_layout_ok(dout):
            dout = dout.contiguous()      # a cotangent in another layout
        if dlse is not None:
            dlse = dlse.float().contiguous()
        delta = flash_delta(out, dout, dlse)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal,
                          ctx.kv_groups)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal,
                               ctx.kv_groups)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None, kv_groups: int = 1,
                    bwd_blocks=None):
    """Flash attention, [B, T, H, D] -> [B, T, H, D].  ``kv_groups > 1``:
    GQA with compact ``k``/``v`` ([B, T, H/g, D]).  The block arguments
    are accepted for the JAX signature; the CUDA tile is fixed."""
    del block_q, block_k, bwd_blocks
    return _FlashAttention.apply(q, k, v, causal, kv_groups)[0]


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             block_q: int = 1024, block_k: int = 1024,
                             kv_groups: int = 1):
    """Like :func:`flash_attention` but also returns the per-row
    natural-log log-sum-exp [B, H, T] f32; both are differentiable."""
    del block_q, block_k
    return _FlashAttention.apply(q, k, v, causal, kv_groups)
