"""Small models: MNIST SLP/MLP and VGG16/19 (counterpart of
kungfu_tpu/models/simple.py).

Images are NCHW tensors (``channels_last`` memory for VGG).  Where the
flax model flattens NHWC features, these flatten them in the same
(h, w, c) order, so a converted Dense kernel needs no permutation of its
rows.  torch needs the input width that flax infers at the first call:
``in_features`` for the perceptrons, ``image_size`` for VGG's first
Dense.  Submodules carry flax's names (``Dense_<n>``, ``Conv_<n>``) for
:func:`kungfu_tpu_torch.convert.load_flax_variables`.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv

__all__ = ["MnistSLP", "MnistMLP", "VGG", "VGG16", "VGG19"]


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W*C] in flax's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _dense(layer: nn.Linear, x, dtype):
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class MnistSLP(nn.Module):
    """Single-layer perceptron: 784 -> 10 (the reference's smoke-test
    model)."""

    def __init__(self, num_classes: int = 10, in_features: int = 784):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, num_classes)

    def forward(self, x):
        return self.Dense_0(_flatten_nhwc(x))


class MnistMLP(nn.Module):
    def __init__(self, hidden: Sequence[int] = (128, 64),
                 num_classes: int = 10, in_features: int = 784):
        super().__init__()
        widths = [in_features, *hidden, num_classes]
        for i in range(len(widths) - 1):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        self.layers = len(widths) - 1

    def forward(self, x):
        x = _flatten_nhwc(x)
        for i in range(self.layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.layers - 1:
                x = F.relu(x)
        return x


class VGG(nn.Module):
    """VGG-16/19 (conv config D/E): 3x3 SAME convs with bias, 2x2 max-pools,
    two Dense 4096 in ``dtype`` and an f32 head."""

    def __init__(self, cfg: Sequence[Any] = (
            64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"),
            num_classes: int = 1000, dtype=torch.bfloat16,
            image_size: int = 224):
        super().__init__()
        self.cfg, self.dtype = list(cfg), dtype
        cin, side, n = 3, image_size, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
            else:
                setattr(self, f"Conv_{n}",
                        Conv(cin, v, 3, bias=True, dtype=dtype))
                cin, n = v, n + 1
        self.Dense_0 = nn.Linear(cin * side * side, 4096)
        self.Dense_1 = nn.Linear(4096, 4096)
        self.Dense_2 = nn.Linear(4096, num_classes)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        n = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{n}")(x))
                n += 1
        x = _flatten_nhwc(x)
        x = F.relu(_dense(self.Dense_0, x, self.dtype))
        x = F.relu(_dense(self.Dense_1, x, self.dtype))
        return _dense(self.Dense_2, x, torch.float32)


VGG16 = VGG
VGG19 = partial(VGG, cfg=(64, 64, "M", 128, 128, "M", 256, 256, 256, 256,
                          "M", 512, 512, 512, 512, "M", 512, 512, 512, 512,
                          "M"))
