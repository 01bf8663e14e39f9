"""K5, the paged-decode kernel: the port's plain version and its wrapper
against the JAX Pallas kernel.

On the CPU the JAX kernel runs in Pallas interpret mode (as its own
tests run it) and the port's wrappers take their plain version, so the
same numpy inputs go through both at ``rtol=atol=2e-5`` in f32 (the
tolerance of tests/test_paged_attention.py).  The CUDA kernel itself is
held against the plain version in tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.ops import paged_attention as JPA
from kungfu_tpu.serving.cache import quantize_kv as jquantize_kv
from kungfu_tpu_torch.ops import paged_attention as TPA
from kungfu_tpu_torch.serving.cache import quantize_kv as tquantize_kv

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand_case(rng, S, H, KVH, Dh, N, bs, MB, ragged=True, Q=1):
    """numpy inputs in the engine's invariants: each slot owns distinct
    non-scratch blocks for its allocated prefix, zeros beyond."""
    q = rng.randn(S, Q, H, Dh).astype(np.float32)
    kp = rng.randn(N, bs, KVH, Dh).astype(np.float32)
    vp = rng.randn(N, bs, KVH, Dh).astype(np.float32)
    pos = (rng.randint(0, MB * bs, S) if ragged
           else np.full(S, MB * bs - 1)).astype(np.int32)
    pos = np.minimum(pos, MB * bs - Q).astype(np.int32)
    tables = np.zeros((S, MB), np.int32)
    free = list(range(1, N))
    rng.shuffle(free)
    for s in range(S):
        for b in range(pos[s] // bs + 1):
            tables[s, b] = free.pop()
    return q, kp, vp, tables, pos


def _both(q, kp, vp, tables, pos, ks=None, vs=None):
    """(port, jax) outputs for the same numpy inputs."""
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    if q.shape[1] == 1:
        got = TPA.paged_attention(t(q[:, 0]), t(kp), t(vp), t(tables),
                                  t(pos), k_scale=t(ks), v_scale=t(vs))
        want = JPA.paged_attention(j(q[:, 0]), j(kp), j(vp), j(tables),
                                   j(pos), k_scale=j(ks), v_scale=j(vs))
    else:
        got = TPA.paged_attention_queries(t(q), t(kp), t(vp), t(tables),
                                          t(pos), k_scale=t(ks),
                                          v_scale=t(vs))
        want = JPA.paged_attention_queries(j(q), j(kp), j(vp), j(tables),
                                           j(pos), k_scale=j(ks),
                                           v_scale=j(vs))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2), (8, 2)])
def test_plain_matches_jax_kernel(H, KVH):
    rng = np.random.RandomState(0)
    S, Dh, bs, MB = 5, 16, 8, 4
    got, want = _both(*_rand_case(rng, S, H, KVH, Dh, S * MB + 1, bs, MB))
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_full_depth_and_depth_zero():
    rng = np.random.RandomState(1)
    S, H, KVH, Dh, bs, MB = 3, 4, 2, 8, 4, 3
    q, kp, vp, tables, pos = _rand_case(rng, S, H, KVH, Dh, S * MB + 1, bs,
                                        MB, ragged=False)
    pos[1] = 0
    got, want = _both(q, kp, vp, tables, pos)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_ignores_scratch_garbage():
    rng = np.random.RandomState(2)
    S, H, KVH, Dh, bs, MB = 2, 4, 4, 16, 4, 4
    q, kp, vp, tables, pos = _rand_case(rng, S, H, KVH, Dh, 12, bs, MB)
    clean, _ = _both(q, kp, vp, tables, pos)
    kp[0] = 1e3
    vp[0] = 1e3
    got, want = _both(q, kp, vp, tables, pos)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, clean, **TOL)


@pytest.mark.parametrize("Q,H,KVH", [(1, 4, 2), (3, 8, 2)])
def test_plain_int8_matches_jax_kernel(Q, H, KVH):
    """int8 pools: the port's quantize_kv gives JAX's bits (round half to
    even, amax/127, max(scale, 1e-30)), then both attends dequantize."""
    rng = np.random.RandomState(7)
    S, Dh, bs, MB = 4, 16, 8, 3
    q, kp, vp, tables, pos = _rand_case(rng, S, H, KVH, Dh, S * MB + 1, bs,
                                        MB, Q=Q)
    kq, ks = tquantize_kv(torch.from_numpy(kp))
    jkq, jks = jquantize_kv(jnp.asarray(kp))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    vq, vs = tquantize_kv(torch.from_numpy(vp))
    got, want = _both(q, kq.numpy(), vq.numpy(), tables, pos, ks.numpy(),
                      vs.numpy())
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("Q,H,KVH", [(2, 4, 2), (4, 4, 4), (3, 8, 2)])
def test_plain_multi_query_matches_jax_kernel(Q, H, KVH):
    """Query j attends keys <= pos + j (the speculative-verify layout)."""
    rng = np.random.RandomState(11)
    S, Dh, bs, MB = 4, 16, 8, 4
    got, want = _both(*_rand_case(rng, S, H, KVH, Dh, S * MB + 1, bs, MB,
                                  Q=Q))
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_bf16_matches_jax_kernel():
    rng = np.random.RandomState(3)
    q, kp, vp, tables, pos = _rand_case(rng, 2, 4, 2, 16, 9, 4, 2)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = TPA.paged_attention(bf(q[:, 0]), bf(kp), bf(vp),
                              torch.from_numpy(tables),
                              torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = JPA.paged_attention(jb(q[:, 0]), jb(kp), jb(vp),
                               jnp.asarray(tables), jnp.asarray(pos))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_wrapper_validates_and_counts_only_launches():
    rng = np.random.RandomState(4)
    q, kp, vp, tables, pos = _rand_case(rng, 2, 4, 2, 8, 9, 4, 2)
    t = torch.from_numpy
    before = TPA.launches
    TPA.paged_attention(t(q[:, 0]), t(kp), t(vp), t(tables), t(pos))
    assert TPA.launches == before         # the CPU path launches nothing
    with pytest.raises(ValueError):
        TPA.paged_attention(t(q[:, 0]), t(kp), t(vp), t(tables), t(pos),
                            k_scale=t(kp[..., 0]))
    with pytest.raises(ValueError):       # H=4 not a multiple of KVH=3
        TPA.paged_attention(t(q[:, 0]), t(kp[:, :, :1].repeat(3, 2)),
                            t(vp[:, :, :1].repeat(3, 2)), t(tables), t(pos))
