"""The ResNet family (counterpart of kungfu_tpu/models/resnet.py), the
framework's headline benchmark model.

Activations are NCHW tensors in ``torch.channels_last`` memory, the
layout cuDNN runs fastest and the one a permuted NHWC batch already has
(``x_nhwc.permute(0, 3, 1, 2)`` is a free view).  ``dtype`` works as
flax's does: parameters stay f32 and are cast to ``dtype`` at each use,
BatchNorm reduces its statistics in f32 and keeps its running statistics
in f32, and the head is an f32 ``Linear`` on the f32 spatial mean of the
features whatever ``dtype`` is.

Submodules carry flax's names (``conv_init``, ``bn_init``,
``BottleneckBlock_<n>`` numbered across stages; ``Conv_0..2``,
``BatchNorm_0..2``, ``conv_proj``, ``norm_proj`` inside a block;
``Dense_0``), so :mod:`kungfu_tpu_torch.convert` maps a flax tree onto the
module by name.

Two places where the torch layers differ from flax's, both handled here:

- flax's ``padding="SAME"`` is what ``lax.padtype_to_pads`` computes:
  ``max((ceil(n/s) - 1)·s + k - n, 0)`` in all, the smaller half before.
  At stride 2 on an even size that is ``(0, 1)``, where
  ``Conv2d(padding=1)`` and ``MaxPool2d(padding=1)`` pad both sides and
  shift every window by a pixel.  :func:`same_pads` computes lax's pads
  from the input's size, and an asymmetric pair is padded explicitly
  (with -inf for the max-pool).
- flax blends the *biased* batch variance into the running variance
  (``ra = 0.9·ra + 0.1·var``); ``F.batch_norm`` blends the unbiased one.
  :class:`BatchNorm` takes back the factor n/(n-1) after the call.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BottleneckBlock", "ResNet", "ResNet50", "ResNet101",
           "ResNet152", "same_pads", "BatchNorm", "Conv", "lecun_normal_"]


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """The (low, high) pads of flax/lax ``padding="SAME"`` along one axis
    of size ``n`` for a window ``k`` at stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """``x`` padded as SAME asks where the pads are asymmetric, and the
    symmetric (h, w) pads left for the layer to apply itself."""
    (t, b), (l, r) = (same_pads(x.shape[2], k, s),
                      same_pads(x.shape[3], k, s))
    if t == b and l == r:
        return x, (t, l)
    x = F.pad(x, (l, r, t, b), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


def lecun_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's default kernel initialiser: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class Conv(nn.Conv2d):
    """flax ``nn.Conv``: SAME padding (or explicit symmetric ``pads``), the
    input and the f32 kernel cast to ``dtype`` at each use."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 pads=None, bias: bool = False, dtype=torch.float32):
        super().__init__(cin, cout, k, stride, bias=bias)
        self.pads, self.dtype = pads, dtype

    def forward(self, x):
        x = x.to(self.dtype)
        if self.pads is None:
            x, pad = _pad_same(x, self.kernel_size[0], self.stride[0])
        else:
            pad = self.pads
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride,
                        pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over
    the channel axis of an NCHW tensor.

    Training normalises with the batch's own statistics, reduced in f32,
    and blends them into the f32 running statistics; evaluation
    normalises with the running statistics.  The result is in the input's
    dtype (the model dtype).  No ``num_batches_tracked``: flax has none.
    """

    def __init__(self, c: int, zero_scale: bool = False,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c) if zero_scale
                                   else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.momentum, self.eps = momentum, eps

    def forward(self, x):
        # scale and bias in f32 whatever the parameters' dtype, as flax
        # promotes them to the f32 of the statistics
        w, b = self.weight.float(), self.bias.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, w,
                                b, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        var = self.running_var.clone()      # autograd keeps this one
        y = F.batch_norm(x, self.running_mean, var, w, b, True,
                         1 - self.momentum, self.eps)
        with torch.no_grad():
            # torch blended var·n/(n-1) into it; flax blends the biased var
            self.running_var.copy_(var.sub(self.running_var,
                                           alpha=self.momentum).mul_(
                (n - 1) / n).add_(self.running_var, alpha=self.momentum))
        return y


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (carrying the stride, as ResNet v1.5), 1x1 x4, with a
    projected shortcut where the shape changes; the last BatchNorm starts
    at scale 0."""

    def __init__(self, cin: int, filters: int, stride: int, dtype):
        super().__init__()
        conv = partial(Conv, dtype=dtype)
        self.Conv_0 = conv(cin, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = conv(filters, filters, 3, stride)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = conv(filters, filters * 4, 1)
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_scale=True)
        if stride != 1 or cin != filters * 4:
            self.conv_proj = conv(cin, filters * 4, 1, stride)
            self.norm_proj = BatchNorm(filters * 4)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """``ResNet(stage_sizes, num_classes, num_filters, dtype,
    small_inputs)``: the flax model's arguments and defaults (bf16).
    ``small_inputs`` takes the CIFAR stem (a 3x3 conv, no max-pool) in
    place of the 7x7 stride-2 conv and the 3x3 stride-2 max-pool.  Call
    :meth:`init` to draw the weights from a seed."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16,
                 small_inputs: bool = False):
        super().__init__()
        self.small_inputs = small_inputs
        if small_inputs:
            self.conv_init = Conv(3, num_filters, 3, dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2,
                                  pads=(3, 3), dtype=dtype)
        self.bn_init = BatchNorm(num_filters)
        cin, n = num_filters, 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                setattr(self, f"BottleneckBlock_{n}",
                        BottleneckBlock(cin, filters, stride, dtype))
                cin, n = filters * 4, n + 1
        self.blocks = n
        self.Dense_0 = nn.Linear(cin, num_classes)
        self.to(memory_format=torch.channels_last)

    def init(self, seed: int = 0) -> "ResNet":
        """flax's initialisers from a ``torch.Generator`` seeded ``seed``
        on the module's device: lecun-normal kernels, zero biases, unit
        BatchNorm scales (zero on each block's last), zero mean and unit
        variance.  Returns the module."""
        g = torch.Generator(device=self.Dense_0.weight.device)
        g.manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Conv):
                lecun_normal_(m.weight, g)
            elif isinstance(m, nn.Linear):
                # lecun over the flax kernel [in, out]: fan_in = in
                lecun_normal_(m.weight, g)
                nn.init.zeros_(m.bias)
        return self

    def forward(self, x):
        """``x``: [B, C, H, W] images (any float dtype) -> f32 logits."""
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        if not self.small_inputs:
            x, pad = _pad_same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2, pad)
        for n in range(self.blocks):
            x = getattr(self, f"BottleneckBlock_{n}")(x)
        # the mean reduces in f32 and rounds to the model dtype, as
        # jnp.mean does; the head runs in f32 (flax Dense(dtype=f32)),
        # its parameters cast to f32 if a compute dtype cast them
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)
        head = self.Dense_0
        return F.linear(x.float(), head.weight.float(), head.bias.float())

    def forward_flops(self, h: int, w: int) -> int:
        """The forward's multiply-add FLOPs (2 per MAC) for one image of
        h x w, from the conv and dense shapes (BatchNorm, activations and
        pooling not counted)."""
        def conv(m: Conv, h, w):
            s, k = m.stride[0], m.kernel_size[0]
            if m.pads is None:
                oh, ow = -(-h // s), -(-w // s)
            else:
                oh = (h + 2 * m.pads[0] - k) // s + 1
                ow = (w + 2 * m.pads[1] - k) // s + 1
            return (2 * m.in_channels * m.out_channels * k * k * oh * ow,
                    oh, ow)

        flops, h, w = conv(self.conv_init, h, w)
        if not self.small_inputs:
            h, w = -(-h // 2), -(-w // 2)
        for n in range(self.blocks):
            blk = getattr(self, f"BottleneckBlock_{n}")
            f0, h1, w1 = conv(blk.Conv_0, h, w)
            f1, h2, w2 = conv(blk.Conv_1, h1, w1)
            f2, _, _ = conv(blk.Conv_2, h2, w2)
            flops += f0 + f1 + f2
            if hasattr(blk, "conv_proj"):
                flops += conv(blk.conv_proj, h, w)[0]
            h, w = h2, w2
        return flops + 2 * self.Dense_0.in_features * \
            self.Dense_0.out_features


ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])
