"""The port's chunked-vocab cross-entropy against the JAX op, on the CPU:
the cases of tests/test_chunked_ce.py.  f32 tolerance 1e-5 (summation
order); bf16 5e-2 against the f32 JAX op, as there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.ops.chunked_ce import chunked_cross_entropy as jce
from kungfu_tpu_torch.ops.chunked_ce import chunked_cross_entropy as tce


def make_case(B=2, T=8, D=16, V=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D).astype(np.float32)
    w = (rng.randn(D, V) * 0.3).astype(np.float32)
    y = rng.randint(0, V, (B, T)).astype(np.int32)
    return x, w, y


def _grads(x, w, y, chunk, g):
    """JAX and port (loss, dx, dW) under the cotangent ``g``."""
    jl, vjp = jax.vjp(lambda a, b: jce(a, b, jnp.asarray(y), chunk),
                      jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = tce(tx, tw, torch.from_numpy(y), chunk)
    tl.backward(torch.from_numpy(g))
    return (np.asarray(jl), np.asarray(jdx), np.asarray(jdw)), \
        (tl.detach().numpy(), tx.grad.numpy(), tw.grad.numpy())


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_loss_and_grads_match_jax(chunk):
    x, w, y = make_case(seed=1)
    g = np.random.RandomState(9).rand(2, 8).astype(np.float32)
    want, got = _grads(x, w, y, chunk, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_repeated_targets_accumulate_in_dw():
    """Every token targets vocab id 0: dW's target column must add up."""
    x, w, _ = make_case(seed=2)
    y = np.zeros((2, 8), np.int32)
    want, got = _grads(x, w, y, 16, np.full((2, 8), 1 / 16, np.float32))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_bf16_inputs_close_to_f32():
    x, w, y = make_case(seed=3)
    want = np.asarray(jce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y),
                          32))
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = tce(xb, wb, torch.from_numpy(y), 32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=5e-2,
                               atol=5e-2)
    got.mean().backward()
    assert xb.grad.dtype == torch.bfloat16


def test_indivisible_chunk_rejected():
    x, w, y = make_case()
    with pytest.raises(ValueError, match="not divisible"):
        tce(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
            48)
