"""The port's int8 weights (ops/quant.py, DecodeEngine(weights_int8=))
against the JAX package's, on the CPU.

``quantize_tensor`` must give JAX's ``q`` and ``scale`` bit for bit on
every layout the GPT has, and the f32 and bf16 dequant must be equal too.
The engines must then emit the same greedy tokens: the port's int8 engine
against the JAX int8 engine and against the port's plain engine run on
the dequantized tree (the oracle of tests/test_weights_int8.py).  The
model is d_model 64, so wq/wk/wv take the per-(head, channel) scale.
Logit tolerances are stated where they are used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.models import gpt as JG
from kungfu_tpu.ops import quant as JQ
from kungfu_tpu.serving import DecodeEngine as JEngine
from kungfu_tpu.serving import Request as JRequest
from kungfu_tpu_torch.convert import params_from_jax
from kungfu_tpu_torch.models import gpt as TG
from kungfu_tpu_torch.ops.quant import (QuantizedTensor, dequantize_weights,
                                        quantize_tensor, quantize_weights)
from kungfu_tpu_torch.serving import DecodeEngine, Request
from kungfu_tpu_torch.serving.engine import _logits, _weights_at_use
from kungfu_tpu_torch.utils.tree import tree_leaves

# vocab 512: the LM head (64 x 512) is the largest weight, as at the
# repo's presets, so a min_size can select it alone
MODEL = dict(vocab_size=512, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=64, rope=True, mlp="swiglu")
ENGINE = dict(num_slots=2, block_size=4, num_blocks=32,
              prompt_buckets=(8, 16), decode_chunk=2)


@pytest.fixture(scope="module")
def models():
    jcfg = JG.GPTConfig(dtype=jnp.float32, **MODEL)
    tcfg = TG.GPTConfig(dtype=torch.float32, **MODEL)
    jp = JG.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x).astype(np.float32))


# ------------------------------------------------------------ quant math
LAYOUTS = {"wq [D,H,Dh]": (64, 4, 16), "wo [H,Dh,D]": (4, 16, 64),
           "wi [D,2,F]": (64, 2, 128), "wm [F,D]": (128, 64),
           "lm_head [D,V]": (64, 97)}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_quantize_tensor_is_bitwise_jax(name):
    """q, scale, and the f32 and bf16 dequant equal JAX's bit for bit;
    half-way quotients (0.5, 1.5, 2.5 of a unit scale) round to even and
    an all-zero column takes the 1e-12 floor."""
    shape = LAYOUTS[name]
    rng = np.random.RandomState(sorted(LAYOUTS).index(name))
    w = (rng.randn(*shape) * 0.3).astype(np.float32)
    # one scale group reads 127 (a unit scale) and three half-way values;
    # another is all zero
    half = (slice(0, 4),) + (0,) * (len(shape) - 1)
    w[half] = [127.0, 0.5, 1.5, 2.5]
    per_axis0 = len(shape) == 3 and shape[0] >= max(shape[1:])
    w[(slice(None), 1, 1) if per_axis0 else (Ellipsis, 1)] = 0.0
    jq = JQ.quantize_tensor(jnp.asarray(w))
    tq = quantize_tensor(torch.from_numpy(w))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert tuple(tq.scale.shape) == jq.scale.shape
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        got = tq.dequant(tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_np(got), _np(jq.dequant(jdt)))
    np.testing.assert_array_equal(tq.q.numpy()[half], [127, 0, 2, 2])
    assert tq.scale.numpy().min() == np.float32(1e-12) / np.float32(127)


def _quantized_paths(tree, is_qt, prefix=""):
    if isinstance(tree, dict):
        return {p for k in tree for p in _quantized_paths(
            tree[k], is_qt, f"{prefix}/{k}")}
    if isinstance(tree, (list, tuple)) and not is_qt(tree):
        return {p for i, t in enumerate(tree) for p in _quantized_paths(
            t, is_qt, f"{prefix}/{i}")}
    return {prefix} if is_qt(tree) else set()


HEAD = 64 * 512


@pytest.mark.parametrize("kw", [{}, {"min_size": HEAD},
                                {"min_size": 64 * 128},
                                {"exclude": ()}],
                         ids=["default", "head_only", "min_8192",
                              "exclude_nothing"])
def test_leaf_selection_matches_jax(models, kw):
    _, jp, _, tp = models
    jqp = JQ.quantize_weights(jp, **kw)
    tqp = quantize_weights(tp, **kw)
    want = _quantized_paths(jqp, lambda x: isinstance(x, JQ.QuantizedTensor))
    got = _quantized_paths(tqp, lambda x: isinstance(x, QuantizedTensor))
    assert got == want and want
    if kw.get("min_size") == HEAD:
        assert got == {"/lm_head"}
    # the values of every quantized leaf are JAX's too
    for path in got:
        node_t, node_j = tqp, jqp
        for k in path.strip("/").split("/"):
            key = int(k) if k.isdigit() else k
            node_t, node_j = node_t[key], node_j[key]
        np.testing.assert_array_equal(node_t.q.numpy(), np.asarray(node_j.q))


def test_double_quantize_raises(models):
    qp = quantize_weights(models[3])
    with pytest.raises(ValueError, match="already quantized"):
        quantize_weights(qp)
    # dequantize restores a plain tree of the same shapes
    deq = dequantize_weights(qp, torch.float32)
    assert [tuple(t.shape) for t in tree_leaves(deq)] == \
        [tuple(t.shape) for t in tree_leaves(models[3])]


def test_engine_quantizes_before_casting(models):
    """A bf16 engine stores the q of the caller's f32 weights.  The
    planted order (cast to bf16, then quantize) gives another q."""
    tcfg = TG.GPTConfig(dtype=torch.bfloat16, **MODEL)
    tp = models[3]
    eng = DecodeEngine(tp, tcfg, device="cpu", weights_int8=True, **ENGINE)
    planted = quantize_weights(TG.cast_params(tp, tcfg))
    want = quantize_weights(tp)
    differ = 0
    for name in ("wq", "wk", "wv", "wo", "wi", "wm"):
        got = eng.params["layers"][0][name]
        assert isinstance(got, QuantizedTensor)
        assert torch.equal(got.q, want["layers"][0][name].q), name
        assert torch.equal(got.scale, want["layers"][0][name].scale), name
        differ += int((planted["layers"][0][name].q != got.q).sum())
    assert differ > 0, "cast-then-quantize gave the same q everywhere"
    assert eng.params["lm_head"].q.dtype == torch.int8
    assert eng.params["wte"].dtype == torch.float32


def test_int8_head_is_bf16_widened_like_jax(models):
    """In bf16 the head reads the bf16 dequant widened to f32, as JAX's
    einsum promotes it.  Limit: 1e-5 of max |logit| against JAX (f32
    sums in another order); an f32 dequant (the planted fault) reads
    above 1e-4."""
    tcfg = TG.GPTConfig(dtype=torch.bfloat16, **MODEL)
    jqp = JQ.quantize_weights(models[1])
    tqp = quantize_weights(models[3])
    x = np.random.RandomState(1).randn(3, 1, 64).astype(np.float32)
    want = np.asarray(JG._head(JQ.dequantize_weights(jqp, jnp.bfloat16),
                               jnp.asarray(x, jnp.bfloat16)))
    got = _logits(tqp, torch.from_numpy(x).to(torch.bfloat16),
                  _weights_at_use(tcfg, True)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    planted = _logits(tqp, torch.from_numpy(x).to(torch.bfloat16),
                      _weights_at_use(TG.GPTConfig(dtype=torch.float32,
                                                   **MODEL), True)).numpy()
    assert np.abs(planted - want).max() > 1e-4 * scale


# ------------------------------------------------------- engine contract
def _requests(seed, n, plen=(2, 14), new=(1, 9)):
    rng = np.random.RandomState(seed)
    return [dict(uid=i, prompt=rng.randint(0, 512, int(rng.randint(*plen)))
                 .tolist(), max_new=int(rng.randint(*new))) for i in range(n)]


@pytest.mark.parametrize("case", ["all", "head_only", "kv_int8_spec3"])
def test_int8_engine_matches_jax_and_the_dequantized_oracle(models, case):
    """Greedy tokens of the port's int8 engine equal the JAX int8
    engine's and those of the port's plain engine on the dequantized
    tree; with ``kv_dtype=int8`` and ``speculative=3`` together, the JAX
    engine's (the composition tests/test_weights_int8.py runs)."""
    jcfg, jp, tcfg, tp = models
    kw = dict(ENGINE)
    min_size = HEAD if case == "head_only" else 0
    if case == "kv_int8_spec3":
        kw.update(speculative=3)
    reqs = _requests(2, 5)
    jeng = JEngine(jp, jcfg, attend="gather", weights_int8=True,
                   weights_int8_min_size=min_size,
                   kv_dtype=jnp.int8 if case == "kv_int8_spec3" else None,
                   **kw)
    want = jeng.run([JRequest(**r) for r in reqs])
    eng = DecodeEngine(tp, tcfg, device="cpu", weights_int8=True,
                       weights_int8_min_size=min_size,
                       kv_dtype=torch.int8 if case == "kv_int8_spec3"
                       else None, **kw)
    got = eng.run([Request(**r) for r in reqs])
    assert got == want
    n_q = sum(isinstance(t, QuantizedTensor) for t in
              [eng.params["lm_head"]] + [t for layer in eng.params["layers"]
                                         for t in layer.values()])
    assert n_q == (1 if case == "head_only" else 1 + 6 * tcfg.n_layers)
    if case == "kv_int8_spec3":
        assert eng.stats.spec_accepted == jeng.stats.spec_accepted
        return
    oracle = dequantize_weights(quantize_weights(tp, min_size=min_size),
                                tcfg.dtype)
    plain = DecodeEngine(oracle, tcfg, device="cpu", **kw).run(
        [Request(**r) for r in reqs])
    assert plain == want
    for r in reqs:
        solo = TG.generate(oracle, tcfg, torch.tensor([r["prompt"]]),
                           r["max_new"])[0].tolist()
        assert got[r["uid"]] == solo, r["uid"]
