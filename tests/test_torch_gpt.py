"""The PyTorch port's GPT against the JAX model, on the CPU in f32.

Weights come from the JAX init and are carried over by
``convert.params_from_jax``, so both sides compute the same function;
the tolerance (1e-5) covers f32 summation order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.models import gpt as JG
from kungfu_tpu_torch import checkpoint as TC
from kungfu_tpu_torch.convert import params_from_jax
from kungfu_tpu_torch.models import gpt as TG

CASES = {
    "gelu-wpe-mha": dict(mlp="gelu", rope=False, n_kv_heads=None),
    "swiglu-rope-gqa": dict(mlp="swiglu", rope=True, n_kv_heads=2),
    "gelu-rope-gqa": dict(mlp="gelu", rope=True, n_kv_heads=2),
    "swiglu-wpe-mha": dict(mlp="swiglu", rope=False, n_kv_heads=None),
}


def _pair(case, seed=0):
    kw = CASES[case]
    jcfg = JG.GPTConfig(vocab_size=97, d_model=32, n_heads=4, n_layers=2,
                        d_ff=64, max_seq=48, dtype=jnp.float32, **kw)
    tcfg = TG.GPTConfig(vocab_size=97, d_model=32, n_heads=4, n_layers=2,
                        d_ff=64, max_seq=48, dtype=torch.float32, **kw)
    jp = JG.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jcfg, jp, tcfg, tp = _pair(case)
    tokens = np.random.RandomState(1).randint(0, 97, (2, 11)).astype(
        np.int32)
    want = np.asarray(JG.forward(jp, jnp.asarray(tokens), jcfg))
    got = TG.forward(tp, torch.from_numpy(tokens), tcfg).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_matches_jax(case):
    jcfg, jp, tcfg, tp = _pair(case)
    prompt = np.random.RandomState(2).randint(0, 97, (2, 5)).astype(
        np.int32)
    want = np.asarray(JG.generate(jp, jcfg, jnp.asarray(prompt), 7))
    got = TG.generate(tp, tcfg, torch.from_numpy(prompt), 7).numpy()
    np.testing.assert_array_equal(got, want)
    # the decode step's logits, not only its argmax
    jcache = JG.init_kv_cache(jcfg, 2, 16)
    jl, jcache = JG.prefill(jp, jcfg, jcache, jnp.asarray(prompt))
    tcache = TG.init_kv_cache(tcfg, 2, 16)
    tl = TG.prefill(tp, tcfg, tcache, torch.from_numpy(prompt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl2, _ = JG.decode_step(jp, jcfg, jcache, 5, jnp.asarray(tok))
    tl2 = TG.decode_step(tp, tcfg, tcache, 5, torch.from_numpy(tok))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-5,
                               atol=1e-5)


def test_layer_pieces_match_jax():
    """rms_norm (f32 with eps 1e-5), split-half RoPE at large positions,
    and the tanh-approximated gelu FFN, one by one."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 32).astype(np.float32) * 3
    scale = rng.rand(32).astype(np.float32) + 0.5
    np.testing.assert_allclose(
        TG.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(JG.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    jcfg, jp, tcfg, tp = _pair("gelu-rope-gqa")
    t = rng.randn(2, 5, 4, 8).astype(np.float32)
    pos = np.array([0, 1, 17, 513, 4097], np.int32)
    np.testing.assert_allclose(
        TG._rope_rotate(torch.from_numpy(t), torch.from_numpy(pos),
                        tcfg).numpy(),
        np.asarray(JG._rope_rotate(jnp.asarray(t), jnp.asarray(pos), jcfg)),
        rtol=1e-5, atol=1e-5)
    h = rng.randn(2, 5, 32).astype(np.float32)
    np.testing.assert_allclose(
        TG._dense_ffn(tp["layers"][0], torch.from_numpy(h), tcfg).numpy(),
        np.asarray(JG._dense_ffn(jp["layers"][0], jnp.asarray(h), jcfg)),
        rtol=1e-5, atol=1e-5)


def test_bf16_forward_tracks_f32():
    """The bf16 model dtype (the card's) runs and stays near f32."""
    _, _, tcfg, tp = _pair("swiglu-rope-gqa")
    bcfg = TG.GPTConfig(**{**tcfg.__dict__, "dtype": torch.bfloat16})
    tokens = torch.from_numpy(
        np.random.RandomState(4).randint(0, 97, (2, 9)).astype(np.int32))
    ref = TG.forward(tp, tokens, tcfg)
    got = TG.forward(TG.cast_params(tp, bcfg), tokens, bcfg)
    assert got.dtype == torch.float32          # f32 logits from f32 head
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0.1,
                               atol=0.1)


def test_npz_from_jax_save_npz_restores(tmp_path):
    """--npz serves what kungfu_tpu.checkpoint.save_npz wrote."""
    from kungfu_tpu.checkpoint import save_npz
    jcfg, jp, tcfg, tp = _pair("swiglu-rope-gqa", seed=5)
    path = str(tmp_path / "w.npz")
    save_npz(path, jp)
    template = TG.init_params(torch.Generator().manual_seed(0), tcfg)
    got = TC.restore_npz_like(template, path)
    np.testing.assert_array_equal(got["layers"][1]["wi"].numpy(),
                                  tp["layers"][1]["wi"].numpy())
    np.testing.assert_array_equal(got["lm_head"].numpy(),
                                  tp["lm_head"].numpy())
    with pytest.raises(ValueError):
        TC.restore_npz_like(TG.init_params(
            torch.Generator().manual_seed(0),
            TG.GPTConfig(**{**tcfg.__dict__, "d_ff": 32})), path)


def test_params_from_jax_rejects_mismatch():
    jcfg, jp, tcfg, _ = _pair("gelu-wpe-mha")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError):            # wpe present, rope wanted
        params_from_jax(tree, TG.GPTConfig(
            **{**tcfg.__dict__, "rope": True}))
    tree["layers"][0]["wq"] = tree["layers"][0]["wq"][:, :2]
    with pytest.raises(ValueError):
        params_from_jax(tree, tcfg)


def test_init_params_shapes_and_seed():
    _, _, tcfg, tp = _pair("swiglu-rope-gqa")
    a = TG.init_params(torch.Generator().manual_seed(7), tcfg)
    b = TG.init_params(torch.Generator().manual_seed(7), tcfg)
    flat = lambda p: [t for _, t in TC._leaves_with_path(p)]
    assert [tuple(t.shape) for t in flat(a)] == \
        [tuple(t.shape) for t in flat(tp)]
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
