"""The serving features of the port on the card: int8 weights and the
prefix cache.  Every test here needs a CUDA device and skips without one.
The file imports no JAX, so it runs on a GPU machine without it, from the
root of the repo:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from kungfu_tpu_torch.models import gpt as G
from kungfu_tpu_torch.ops import paged_attention as PA
from kungfu_tpu_torch.ops.quant import dequantize_weights, quantize_weights
from kungfu_tpu_torch.serving import DecodeEngine, Request
from kungfu_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return resolve_device("cuda")


def test_int8_weights_match_the_dequantized_oracle(cuda_device):
    """A 2-layer bf16 model at the 470m widths: the int8 engine's greedy
    tokens equal those of a plain engine on the dequantized tree (the
    same weight bits in the same batches), through K5."""
    cfg = G.GPTConfig(**dict(chip_smoke.MODEL, n_layers=2),
                      dtype=torch.bfloat16)
    params = G.init_params(
        torch.Generator(device=cuda_device).manual_seed(3), cfg)
    rng = np.random.RandomState(4)
    reqs = [dict(uid=i, prompt=rng.randint(0, cfg.vocab_size,
                                           int(rng.randint(8, 300))).tolist(),
                 max_new=24) for i in range(6)]
    before = PA.launches
    got = DecodeEngine(params, cfg, device=cuda_device, weights_int8=True,
                       **chip_smoke.ENGINE).run([Request(**r) for r in reqs])
    assert PA.launches > before
    oracle = dequantize_weights(quantize_weights(params), cfg.dtype)
    want = DecodeEngine(oracle, cfg, device=cuda_device,
                        **chip_smoke.ENGINE).run([Request(**r) for r in reqs])
    assert got == want


def test_f32_prefix_cache_matches_cache_off(cuda_device):
    """tests/test_prefix_cache.py's roomy, eviction and preemption cases
    at 2 layers, full width, f32 (chip_smoke's ``prefix_f32_2l``)."""
    out = chip_smoke.phase_prefix_f32(cuda_device)
    assert out["tokens_equal"]
    assert out["cases"]["preemption"]["preemptions"] >= 1


def test_tp2_engine_over_gloo_matches_tp1(cuda_device):
    """chip_smoke's ``tp2_f32_2l``: the tp-2 engine over gloo on the card
    (2 ranks, full width, 2 layers, f32) gives tp 1's tokens, stats and
    K5 launches with int8 weights + int8 KV + speculative 3 and in the
    prefix cache's three cases; ``make_tp_generate`` gives
    ``G.generate``'s tokens."""
    out = chip_smoke.phase_tp2_f32(cuda_device)
    assert out["tokens_equal"] and out["generate_equal"]
