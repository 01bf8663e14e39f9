"""Per-channel symmetric int8 weight quantization for serving (W8A16;
counterpart of kungfu_tpu/ops/quant.py).

The matmul weights are stored as int8 plus an f32 scale per output
channel (per head and channel for the fan-in layouts), about half the
bytes of the bf16 tree, so the card holds more KV blocks.  Activations
stay in the model dtype: the engine dequantizes each layer's weights at
that layer's use, inside every program (one ``q * scale`` elementwise
kernel per weight, nothing held across layers), and the products stay
``torch.matmul``/``einsum``.  The JAX package's XLA fuses that dequant
into the dot's operand read; eager PyTorch runs it as its own kernel.

The quantized model is a different, deterministic function of the
prompt: the engine's oracle is the plain decoder run on
``dequantize_weights(quantize_weights(params), dtype)``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..utils.tree import tree_map


class QuantizedTensor:
    """An int8 weight ``q`` and its f32 ``scale`` (broadcastable to
    ``q``).  A plain holder: the port's parameter trees are dictionaries
    and lists, walked by :func:`quantize_weights` and
    :func:`dequantize_weights`."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    def dequant(self, dtype) -> torch.Tensor:
        """``q * scale`` in ``dtype``: the JAX package's
        ``q.astype(dtype) * scale.astype(dtype)`` (an int8 value is
        exact in bf16, and PyTorch forms the bf16 product in f32 and
        rounds once, which is the correctly rounded bf16 product)."""
        return self.q * self.scale.to(dtype)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device))

    def __repr__(self):
        return (f"QuantizedTensor(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def quantize_tensor(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric int8 with ``|dequant - w| <= scale / 2`` per element.

    Granularity (the JAX rule): amax over axis 0 alone when axis 0 is
    the dominant axis of a 3-D weight (the fan-in layout: wq/wk/wv
    ``[D, H, Dh]`` get a scale per (head, channel)); otherwise over all
    leading axes (wo ``[H, Dh, D]``, wi ``[D, 2, F]``, wm and lm_head:
    a scale per output column).  Rounds half to even, as ``jnp.round``."""
    w32 = w.float()
    if w.ndim >= 3 and w.shape[0] >= 64 and w.shape[0] >= max(w.shape[1:]):
        amax = w32.abs().amax(dim=0, keepdim=True)
    else:
        amax = w32.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def quantize_weights(params, exclude: Sequence[str] = ("wte", "wpe"),
                     min_size: int = 0):
    """Quantize every floating tensor of ``params`` with ``ndim >= 2``
    and at least ``min_size`` elements (0: no minimum); norm gains and
    any top-level key in ``exclude`` pass through.  ``wte``/``wpe`` are
    excluded by default: decode gathers a few of their rows, it does not
    stream them.  Raises on a tree that is already quantized."""
    def q(leaf):
        if isinstance(leaf, QuantizedTensor):
            raise ValueError("params are already quantized "
                             "(QuantizedTensor leaf found)")
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                and leaf.is_floating_point()
                and (min_size == 0 or leaf.numel() >= min_size)):
            return quantize_tensor(leaf)
        return leaf

    return {k: v if k in exclude else tree_map(q, v)
            for k, v in params.items()}


def quantize_specs(params_q, specs):
    """The split dimensions (``models.gpt.param_specs``) of a
    :func:`quantize_weights` output: a QuantizedTensor leaf's becomes
    ``QuantizedTensor(weight_dim, scale_dim)``, where the scale splits on
    the weight's dimension unless its size there is 1 (replicated: None).
    Quantization reduces over leading axes of the full tree, so a shard's
    dequant equals the slice of the full dequant; quantize first, then
    shard (``parallel.threed.shard_params``)."""
    def f(leaf, dim):
        if not isinstance(leaf, QuantizedTensor):
            return dim
        sdim = (None if dim is None or leaf.scale.shape[dim] == 1
                else dim)
        return QuantizedTensor(dim, sdim)
    return tree_map(f, params_q, specs)


def dequantize_weights(params, dtype):
    """Inverse of :func:`quantize_weights`: QuantizedTensor leaves become
    ``dtype`` tensors, everything else passes through.  The engine calls
    it on one layer's dictionary at that layer's use."""
    return tree_map(lambda x: x.dequant(dtype)
                    if isinstance(x, QuantizedTensor) else x, params)
