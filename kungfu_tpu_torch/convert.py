"""Carry a JAX GPT parameter tree over to the port.

The port keeps the JAX package's parameter names and layouts, so the
conversion is a named, shape-checked copy: every leaf the configuration
needs must be present with exactly the shape it expects, and nothing
else may be.  The tree's leaves are anything ``np.asarray`` accepts
(numpy arrays, or JAX arrays handed over by a caller that imports JAX).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.gpt import GPTConfig, param_shapes


def params_from_jax(tree: Dict, cfg: GPTConfig, device="cpu") -> Dict:
    """f32 tensors on ``device`` with the same nesting as ``tree``."""
    want = param_shapes(cfg)

    def copy(path, node, shape):
        if isinstance(shape, dict):
            if not isinstance(node, dict) or set(node) != set(shape):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path or '<root>'}: keys {got} != "
                                 f"expected {sorted(shape)}")
            return {k: copy(f"{path}/{k}".lstrip("/"), node[k], shape[k])
                    for k in shape}
        if isinstance(shape, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(shape):
                raise ValueError(f"{path}: expected {len(shape)} layers")
            return [copy(f"{path}/{i}", n, s)
                    for i, (n, s) in enumerate(zip(node, shape))]
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape} != expected "
                             f"{tuple(shape)}")
        return torch.tensor(arr, device=device)

    return copy("", tree, want)
