"""Serving: continuous-batching decode over a paged KV cache, on PyTorch
and CUDA (counterpart of kungfu_tpu/serving).

    from kungfu_tpu_torch.serving import DecodeEngine, Request
    eng = DecodeEngine(params, cfg, num_slots=8, block_size=32,
                       num_blocks=256)            # device="cuda" default
    results = eng.run([Request(uid=0, prompt=[...], max_new=64), ...])
    print(eng.stats.summary())
"""
from .cache import (init_paged_pools, paged_decode_attend, paged_gather,
                    paged_write_prompt, paged_write_token)
from .engine import DecodeEngine, EngineStats, Request
from .server import ServingServer

__all__ = ["DecodeEngine", "EngineStats", "Request", "ServingServer",
           "init_paged_pools", "paged_decode_attend", "paged_gather",
           "paged_write_prompt", "paged_write_token"]
