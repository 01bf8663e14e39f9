"""GQA head expansion shared by the dense attends (counterpart of
``_expand_kv_heads`` in kungfu_tpu/ops/flash_attention.py).  The flash
kernels themselves come with the training slice of the port."""
from __future__ import annotations


def _expand_kv_heads(t, kv_groups: int):
    """[B, T, Hkv, D] -> [B, T, Hkv*g, D] (repeat: query head h reads KV
    head h // g)."""
    return t if kv_groups == 1 else t.repeat_interleave(kv_groups, dim=2)
