"""Tensor-parallel building blocks, Megatron-style column and row
sharding (counterpart of kungfu_tpu/parallel/tensor.py).

Each rank of the tp group holds its slice of the weight:

- :func:`column_parallel`: the weight sharded on its output features; the
  product needs no collective and the activations come out
  feature-sharded.  The replicated input enters through
  ``copy_to_group`` (identity forward, its gradient summed over the
  group), where shard_map's AD sums the input's cotangent in JAX.
- :func:`row_parallel`: the weight sharded on its input features; one
  all-reduce completes the contraction and restores replicated
  activations (``reduce_from_group``: its gradient is the identity).

The MLP block is column_parallel -> activation -> row_parallel: one
all-reduce forward and one backward.
"""
from __future__ import annotations

from ..comm.collectives import copy_to_group, reduce_from_group


def column_parallel(x, w_local, group, b_local=None):
    """x: [..., d_in] replicated; w_local: [d_in, d_out/n].  Returns
    [..., d_out/n] feature-sharded activations; x's gradient is summed
    over ``group`` (the tp group)."""
    y = copy_to_group(x, group) @ w_local
    if b_local is not None:
        y = y + b_local
    return y


def row_parallel(x_local, w_local, group, b=None):
    """x_local: [..., d_in/n] feature-sharded; w_local: [d_in/n, d_out].
    One all-reduce over ``group`` restores replicated [..., d_out]."""
    y = reduce_from_group(x_local @ w_local, group)
    if b is not None:
        y = y + b
    return y
