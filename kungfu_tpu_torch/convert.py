"""Carry JAX parameter trees over to the port, and back.

The GPT keeps the JAX package's parameter names and layouts
(:func:`params_from_jax`).  The flax models (ResNet, the simple models,
BERT) are ``nn.Module``s whose submodules carry flax's names, so their
conversion (:func:`load_flax_variables`, :func:`flax_variables`) maps
each flax leaf onto a parameter or buffer by name and changes only its
layout.  Either way the conversion is a named, shape-checked copy: every
leaf the model needs must be present with exactly the shape it expects,
and nothing else may be.  The tree's leaves are anything ``np.asarray``
accepts (numpy arrays, or JAX arrays handed over by a caller that
imports JAX).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from .models.gpt import GPTConfig, param_shapes
from .models.resnet import BatchNorm


def params_from_jax(tree: Dict, cfg, device="cpu") -> Dict:
    """f32 tensors on ``device`` with the same nesting as ``tree``, a GPT
    (``cfg`` a ``GPTConfig``) or a MoE-GPT (a
    ``parallel.moe_gpt.MoEGPTConfig``: each MoE layer holds ``moe:
    {router, wi, wo}`` in place of ``wi``/``wm``).  A rank of a (dp, sp,
    tp) mesh takes its slices of the result with
    ``parallel.threed.shard_params``, a MoE-GPT rank its experts with
    ``parallel.moe_gpt.shard_params``, as JAX's ``shard_params`` places
    the full tree on the mesh.  A pipeline rank's tree is the result
    stacked (``parallel.pipeline.stack_layers``), put in the interleaved
    order (``interleave_params``) and sharded (``shard_params``), as
    JAX's ``init_gpt_pp`` builds it."""
    if isinstance(cfg, GPTConfig):
        want = param_shapes(cfg)
    else:
        from .parallel.moe_gpt import param_shapes as moe_gpt_shapes
        want = moe_gpt_shapes(cfg)

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


# ------------------------------------------------- flax modules <-> nn.Module
# How each torch layer's tensors sit in a flax variables tree: torch name ->
# (collection, flax name, the torch axes in flax's order or None).  A
# tensor of any other module keeps its name under "params".
LAYOUTS = (
    (nn.Conv2d, {"weight": ("params", "kernel", (2, 3, 1, 0)),
                 "bias": ("params", "bias", None)}),
    (nn.Linear, {"weight": ("params", "kernel", (1, 0)),
                 "bias": ("params", "bias", None)}),
    (BatchNorm, {"weight": ("params", "scale", None),
                 "bias": ("params", "bias", None),
                 "running_mean": ("batch_stats", "mean", None),
                 "running_var": ("batch_stats", "var", None)}),
    (nn.LayerNorm, {"weight": ("params", "scale", None),
                    "bias": ("params", "bias", None)}),
    (nn.Embedding, {"weight": ("params", "embedding", None)}),
)


def flax_layout(module) -> Dict[Tuple[str, ...], Tuple[torch.Tensor, Any]]:
    """Every parameter and buffer of ``module`` under its flax key
    ``(collection, *module path, leaf)``, with the permutation that takes
    its torch axes to flax's (conv OIHW -> HWIO, Linear [out, in] ->
    Dense [in, out]) or None."""
    out = {}
    for name, m in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        table = next((t for cls, t in LAYOUTS if isinstance(m, cls)), {})
        tensors = list(m.named_parameters(recurse=False)) + list(
            m.named_buffers(recurse=False))
        for tname, t in tensors:
            coll, leaf, perm = table.get(tname, ("params", tname, None))
            out[(coll,) + path + (leaf,)] = (t, perm)
    return out


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def load_flax_variables(module, variables: Dict):
    """Copy a flax variables tree (``{"params": ..., "batch_stats": ...}``
    of numpy arrays) into ``module``'s parameters and buffers in place,
    as strictly as :func:`params_from_jax`: a missing key, an extra key
    or a wrong shape raises.  Returns ``module``."""
    want, got = flax_layout(module), _flatten(variables)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"flax keys: missing {['/'.join(k) for k in missing]}"
                         f", unexpected {['/'.join(k) for k in extra]}")
    with torch.no_grad():
        for key, (t, perm) in want.items():
            arr = np.array(got[key], dtype=np.float32)     # a copy
            shape = tuple(t.shape[i] for i in perm) if perm else t.shape
            if arr.shape != tuple(shape):
                raise ValueError(f"{'/'.join(key)}: shape {arr.shape} != "
                                 f"expected {tuple(shape)}")
            v = torch.from_numpy(arr)
            if perm:
                v = v.permute(*np.argsort(perm).tolist())
            t.copy_(v)
    return module


def flax_variables(module) -> Dict:
    """The reverse of :func:`load_flax_variables`: ``module``'s parameters
    and buffers as f32 numpy arrays in flax's nested tree and layouts."""
    out: Dict = {}
    for key, (t, perm) in flax_layout(module).items():
        v = t.detach().float().cpu()
        node = out
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = np.ascontiguousarray(
            (v.permute(*perm) if perm else v).numpy())
    return out
