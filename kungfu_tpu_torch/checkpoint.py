"""Read the flat ``.npz`` checkpoints the JAX package writes.

``kungfu_tpu.checkpoint.save_npz`` dumps a parameter tree with one entry
per leaf, keyed by its key path: dictionary keys and list indices joined
by ``/`` (``"layers/0/wq"``, ``"lm_head"``).  This module decodes that
scheme with numpy alone, so ``python -m kungfu_tpu_torch.serving --npz``
serves weights the JAX side trained.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple, Union

import numpy as np
import torch


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(template, values: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return values[prefix[:-1]]


def restore_npz_like(template, flat: Union[str, Dict[str, np.ndarray]]):
    """Rebuild a tree of tensors shaped like ``template`` from
    :func:`load_npz`'s dict (or a path): each leaf is looked up by its
    key path, shape-checked, and converted to the template leaf's dtype
    and device."""
    if isinstance(flat, str):
        flat = load_npz(flat)
    values = {}
    for key, leaf in _leaves_with_path(template):
        if key not in flat:
            raise KeyError(f"checkpoint is missing {key!r}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key!r}: checkpoint shape {arr.shape} != "
                             f"model shape {tuple(leaf.shape)}")
        values[key] = torch.tensor(arr, device=leaf.device,
                                   dtype=leaf.dtype)
    return _rebuild(template, values)
