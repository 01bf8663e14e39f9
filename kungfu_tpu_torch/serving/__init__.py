"""Serving: continuous-batching decode over a paged KV cache, on PyTorch
and CUDA (counterpart of kungfu_tpu/serving).

    from kungfu_tpu_torch.serving import DecodeEngine, Request
    eng = DecodeEngine(params, cfg, num_slots=8, block_size=32,
                       num_blocks=256,            # device="cuda" default
                       weights_int8=True, prefix_cache=True)
    results = eng.run([Request(uid=0, prompt=[...], max_new=64), ...])
    print(eng.stats.summary())

Tensor parallelism: every rank of a process group builds
``DecodeEngine(params, cfg, mesh=comm.mesh.serving_mesh(n), ...)``; rank
0 drives it as above and the others call ``eng.follow()``
(``serving/tp.py``; ``python -m kungfu_tpu_torch.serving --tp n``).
"""
from .cache import (init_paged_pools, paged_decode_attend, paged_gather,
                    paged_write_prompt, paged_write_token)
from .engine import DecodeEngine, EngineStats, Request
from .server import ServingServer
from .slo import SLO, RequestJournal, RequestRecord

__all__ = ["DecodeEngine", "EngineStats", "Request", "RequestJournal",
           "RequestRecord", "SLO", "ServingServer", "init_paged_pools",
           "paged_decode_attend", "paged_gather", "paged_write_prompt",
           "paged_write_token"]
