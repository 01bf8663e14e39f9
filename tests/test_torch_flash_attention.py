"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (as
tests/test_flash_attention.py does); the port's wrappers run their plain
versions on CPU tensors, through the same autograd function
(``_FlashAttention``) that chains the CUDA kernels K1-K4 on the card.
Tolerances: f32 2e-5 (summation order only); bf16 2e-2 (one bf16 ulp of
outputs of order 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.ops import flash_attention as JF
from kungfu_tpu_torch.ops import flash_attention as TF

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _inputs(B=2, Tq=64, Tk=None, H=4, g=1, D=16, seed=0):
    rng = np.random.RandomState(seed)
    Tk = Tk or Tq
    q = rng.randn(B, Tq, H, D).astype(np.float32)
    k = rng.randn(B, Tk, H // g, D).astype(np.float32)
    v = rng.randn(B, Tk, H // g, D).astype(np.float32)
    do = rng.randn(B, Tq, H, D).astype(np.float32)
    dlse = rng.randn(B, H, Tq).astype(np.float32)
    return q, k, v, do, dlse


def _t(a, grad=True):
    return torch.from_numpy(a).requires_grad_(grad)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,bq,bk", [(False, 32, 16), (True, 16, 32),
                                          (True, 32, 32)])
def test_forward_and_grads_match_jax_multiblock(causal, bq, bk):
    """Several JAX tiles per row (T=64, blocks 16/32): the carried
    accumulators against the port's autograd function."""
    q, k, v, do, _ = _inputs(seed=1)

    def jloss(q, k, v):
        return jnp.sum(JF.flash_attention(q, k, v, causal, bq, bk) * do)

    jout = JF.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, bq, bk)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = TF.flash_attention(tq, tk, tv, causal, bq, bk)
    (out * torch.from_numpy(do)).sum().backward()
    _close(out.detach(), jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, want)


def _gqa_grads_match_jax(H, g, seed):
    q, k, v, do, _ = _inputs(Tq=32, H=H, g=g, seed=seed)

    def jloss(q, k, v):
        return jnp.sum(JF.flash_attention(q, k, v, True, 16, 16,
                                          kv_groups=g) * do)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = TF.flash_attention(tq, tk, tv, True, kv_groups=g)
    (out * torch.from_numpy(do)).sum().backward()
    assert tk.grad.shape == tk.shape
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, want)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_gqa_compact_kv_grads_match_jax(g):
    """kv_groups g: compact k/v in, compact dk/dv out, equal to the JAX
    op's (the group-sum of the expanded gradients)."""
    _gqa_grads_match_jax(4, g, seed=2)


@pytest.mark.parametrize("g", [8, 16])
def test_gqa_wide_groups_match_jax(g):
    """Groups of 8 and 16 query heads per KV head (H = 16, so g = 16 is
    multi-query): the group sizes at and past the largest cluster that
    sums them in K4 on the card."""
    _gqa_grads_match_jax(16, g, seed=7)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_and_dlse_cotangent_match_jax(causal):
    """Both outputs of flash_attention_with_lse are differentiable; the
    lse cotangent folds into delta (delta - dlse)."""
    q, k, v, do, dlse = _inputs(Tq=32, g=2, seed=3)

    def jloss(q, k, v):
        o, lse = JF.flash_attention_with_lse(q, k, v, causal, 16, 16,
                                             kv_groups=2)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    jo, jlse = JF.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 16, 16,
        kv_groups=2)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out, lse = TF.flash_attention_with_lse(tq, tk, tv, causal, kv_groups=2)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 32)
    ((out * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    _close(out.detach(), jo)
    _close(lse.detach(), jlse)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, want)


def test_bf16_forward_matches_jax():
    q, k, v, _, _ = _inputs(seed=4)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = JF.flash_attention(bf(q), bf(k), bf(v), True, 32, 32)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = TF.flash_attention(tb(q), tb(k), tb(v), True)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), BF16_TOL)


@pytest.mark.parametrize("Tq,Tk", [(24, 40), (40, 24), (50, 50)])
def test_plain_version_matches_jnp_twin(Tq, Tk):
    """flash_attention_ref against _jnp_flash, out and lse, including
    Tq != Tk (causal mask qpos >= kpos from 0) and a ragged T of 50 that
    the TPU kernels' multiple-of-8 rule would refuse."""
    q, k, v, _, _ = _inputs(Tq=Tq, Tk=Tk, seed=5)
    for causal in (False, True):
        jo, jl = JF._jnp_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal)
        to, tl = TF.flash_attention_ref(_t(q, False), _t(k, False),
                                        _t(v, False), causal)
        _close(to, jo)
        _close(tl, jl)


def _plain_backward_matches_autograd(Tq, Tk, H, g, seed):
    q, k, v, do, dlse = _inputs(Tq=Tq, Tk=Tk, H=H, g=g, seed=seed)
    tq, tk, tv = _t(q), _t(k), _t(v)
    out, lse = TF.flash_attention_ref(tq, TF._expand_kv_heads(tk, g),
                                      TF._expand_kv_heads(tv, g), True)
    ((out * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    o, l = out.detach(), lse.detach()
    delta = TF.flash_delta(o, torch.from_numpy(do), torch.from_numpy(dlse))
    dq = TF.flash_bwd_dq(_t(q, False), _t(k, False), _t(v, False),
                         torch.from_numpy(do), l, delta, True, g)
    dk, dv = TF.flash_bwd_dkv(_t(q, False), _t(k, False), _t(v, False),
                              torch.from_numpy(do), l, delta, True, g)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        _close(got, want)


def test_kernel_plain_backward_matches_autograd_of_ref():
    """K2-K4's plain versions (what the kernels compute) equal autograd
    through the plain forward, for a ragged Tq != Tk GQA case."""
    _plain_backward_matches_autograd(37, 53, 4, 2, seed=6)


@pytest.mark.parametrize("Tq,Tk,H,g", [(1, 1, 8, 4), (65, 65, 8, 4),
                                       (40, 72, 16, 16), (72, 40, 16, 8)])
def test_kernel_plain_backward_edge_shapes(Tq, Tk, H, g):
    """The same at the shapes chip_smoke adds for K3/K4's schedule: T = 1
    and T = 65 (one row past a 64-row tile), causal Tq != Tk both ways,
    groups of 16 and 8 query heads."""
    _plain_backward_matches_autograd(Tq, Tk, H, g, seed=8)


def test_wrappers_reject_bad_shapes():
    q, k, v, _, _ = _inputs(Tq=16, g=2)
    with pytest.raises(ValueError, match="KV heads"):
        TF.flash_forward(_t(q, False), _t(k, False), _t(v, False), True, 4)
    with pytest.raises(ValueError, match="do not agree"):
        TF.flash_forward(_t(q, False), _t(k, False), _t(v[:, :8], False),
                         True, 2)
