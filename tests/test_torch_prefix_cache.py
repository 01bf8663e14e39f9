"""The port's prefix cache (DecodeEngine(prefix_cache=True)) against the
JAX engine's, on the CPU in f32.

The cases of tests/test_prefix_cache.py, each run through both engines on
the same converted weights and requests: greedy tokens, ``prefix_hits``,
``prefix_tokens_reused``, prefills and preemptions must be equal (the
sampled case compares the port's cache on with its cache off, since the
port's sampling bits differ from JAX's by design).  The suffix prefill
alone is held against JAX's ``_make_prefill_cached`` on the same pool
contents, with aliased block tables: the first tokens equal, the written
blocks within 1e-5 (f32 sums in another order), every other block
untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.models import gpt as JG
from kungfu_tpu.serving import DecodeEngine as JEngine
from kungfu_tpu.serving import Request as JRequest
from kungfu_tpu.serving.cache import init_paged_pools as j_init_pools
from kungfu_tpu.serving.engine import (_make_prefill_cached as
                                       j_make_prefill_cached)
from kungfu_tpu_torch.convert import params_from_jax
from kungfu_tpu_torch.models import gpt as TG
from kungfu_tpu_torch.serving import DecodeEngine, Request
from kungfu_tpu_torch.serving.cache import init_paged_pools
from kungfu_tpu_torch.serving.engine import _make_prefill_cached

# tests/test_prefix_cache.py's model
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=64, max_seq=128, rope=True)
PREFIX = [7, 3, 9, 1, 8, 2, 6, 4, 5, 9, 2, 7, 1, 3, 8, 6]  # 4 blocks of 4


@pytest.fixture(scope="module")
def models():
    jcfg = JG.GPTConfig(dtype=jnp.float32, **MODEL)
    tcfg = TG.GPTConfig(dtype=torch.float32, **MODEL)
    jp = JG.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _shared_reqs(n=4, max_new=6, **kw):
    return [dict(uid=i, prompt=PREFIX + [10 + i, 20 + i], max_new=max_new,
                 **kw) for i in range(n)]


def _kw(**kw):
    # prefill_group=1: admissions are sequential, so each request after
    # the first probes a cache the earlier ones filled
    for k, v in dict(prefill_group=1, num_slots=4, block_size=4,
                     num_blocks=64, prompt_buckets=(8, 32)).items():
        kw.setdefault(k, v)
    return kw


STATS = ("prefix_hits", "prefix_tokens_reused", "prefills", "preemptions")


def _both(models, batches, **kw):
    """Run each list of requests in ``batches`` through one JAX engine and
    one port engine in turn; tokens and stats must be equal.  Returns the
    port engine and its results per batch."""
    jcfg, jp, tcfg, tp = models
    jeng = JEngine(jp, jcfg, attend="gather", **_kw(**kw))
    eng = DecodeEngine(tp, tcfg, device="cpu", **_kw(**kw))
    outs = []
    for reqs in batches:
        want = jeng.run([JRequest(**r) for r in reqs])
        got = eng.run([Request(**r) for r in reqs])
        assert got == want
        outs.append(got)
    for name in STATS:
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name
    return eng, outs


def _off(models, reqs, **kw):
    kw.pop("prefix_cache", None)
    return DecodeEngine(models[3], models[2], device="cpu",
                        **_kw(**kw)).run([Request(**r) for r in reqs])


def test_tokens_match_cache_off_engine(models):
    eng, (got,) = _both(models, [_shared_reqs()], prefix_cache=True)
    assert got == _off(models, _shared_reqs())
    assert eng.stats.prefix_hits >= 1
    assert eng.stats.prefix_tokens_reused >= 16


def test_tokens_match_solo_oracle(models):
    tcfg, tp = models[2], models[3]
    _, (got,) = _both(models, [_shared_reqs(6)], prefix_cache=True,
                      num_slots=2)
    for r in _shared_reqs(6):
        solo = TG.generate(tp, tcfg, torch.tensor([r["prompt"]]),
                           r["max_new"])[0].tolist()
        assert got[r["uid"]] == solo, r["uid"]


def test_repeated_identical_prompt_reuses_blocks(models):
    r1 = dict(uid=1, prompt=PREFIX + [11], max_new=4)
    r2 = dict(uid=2, prompt=PREFIX + [11], max_new=4)
    eng, (out, out2) = _both(models, [[r1], [r2]], prefix_cache=True,
                             num_slots=1)
    assert out[1] == out2[2]
    assert eng.stats.prefix_tokens_reused >= 16


def test_sampled_requests_with_prefix_cache(models):
    """The sampling discipline survives the cache: cached and uncached
    admissions of one request give the same stream."""
    reqs = [dict(uid=i, prompt=PREFIX + [30 + i], max_new=5,
                 temperature=0.9, top_k=12) for i in range(3)]
    eng = DecodeEngine(models[3], models[2], device="cpu",
                       **_kw(prefix_cache=True))
    got = eng.run([Request(**r) for r in reqs])
    assert eng.stats.prefix_hits == 2
    assert got == _off(models, reqs)


def test_eviction_under_pressure_stays_correct(models):
    eng, (got,) = _both(models, [_shared_reqs(6, max_new=4)],
                        prefix_cache=True, num_slots=2, num_blocks=14)
    assert got == _off(models, _shared_reqs(6, max_new=4))


def test_lru_eviction_drops_the_oldest_prefix(models):
    """One slot, 7 usable blocks: B's admission evicts A's first cached
    blocks (least recently freed first), so B's repeat finds its four
    blocks and A's repeat finds none."""
    a = [7 + i % 5 for i in range(16)] + [1]
    b = [3 + i % 7 for i in range(16)] + [2]
    eng, outs = _both(models, [[dict(uid=i, prompt=p, max_new=3)]
                               for i, p in enumerate((a, b, b, a))],
                      prefix_cache=True, num_slots=1, num_blocks=8)
    assert outs[0][0] == outs[3][3] and outs[1][1] == outs[2][2]
    assert eng.stats.prefix_hits == 1
    assert eng.stats.prefix_tokens_reused == 16


def _spy_pins(eng):
    """Record the engine's pinned prefix blocks after each preemption."""
    seen, preempt = [], eng._preempt_for

    def spy(slot):
        out = preempt(slot)
        seen.append({u: list(b) for u, b in eng._pinned.items()})
        for blocks in eng._pinned.values():
            assert all(eng._block_ref[b] > 0 for b in blocks)
        return out

    eng._preempt_for = spy
    return seen


def test_preemption_with_prefix_cache_deterministic(models):
    """The victim keeps references on its prefix blocks (the same pins as
    the JAX engine's after every preemption), its replay re-admits on
    them, and the stream equals the cache-off run."""
    jcfg, jp, tcfg, tp = models
    kw = _kw(prefix_cache=True, num_slots=4, num_blocks=16)
    reqs = _shared_reqs(5, max_new=8)
    jeng = JEngine(jp, jcfg, attend="gather", **kw)
    eng = DecodeEngine(tp, tcfg, device="cpu", **kw)
    want_pins, got_pins = _spy_pins(jeng), _spy_pins(eng)
    want = jeng.run([JRequest(**r) for r in reqs])
    got = eng.run([Request(**r) for r in reqs])
    assert got == want == _off(models, reqs)
    assert eng.stats.preemptions >= 1
    assert got_pins == want_pins and any(got_pins)
    assert not eng._pinned and int((eng._block_ref > 0).sum()) == 0
    for name in STATS:
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name


def test_int8_pool_rejects_prefix_cache(models):
    with pytest.raises(ValueError, match="prefix_cache"):
        DecodeEngine(models[3], models[2], device="cpu",
                     **_kw(prefix_cache=True, kv_dtype=torch.int8))


def test_refcounts_return_to_zero(models):
    eng, _ = _both(models, [_shared_reqs(4)], prefix_cache=True)
    assert int((eng._block_ref > 0).sum()) == 0
    assert eng._available() == eng._total_blocks
    assert not eng._pinned and not eng._admit_split


def test_prefix_cache_with_int8_weights(models):
    eng, (got,) = _both(models, [_shared_reqs(5, max_new=5)],
                        prefix_cache=True, weights_int8=True)
    assert eng.stats.prefix_hits >= 1


def test_suffix_prefill_matches_jax_on_the_same_pool(models):
    """Two rows whose tables alias the same three prefix blocks (12
    tokens) and one a further cached block (16), each with its own
    suffix blocks, over random pool contents."""
    jcfg, jp, tcfg, tp = models
    bs, nb, mb = 4, 24, 8
    rng = np.random.RandomState(0)
    contents = [{k: rng.randn(nb, bs, 2, 8).astype(np.float32)
                 for k in ("k", "v")} for _ in range(tcfg.n_layers)]
    jpools = [{k: jnp.asarray(c[k]) for k in c} for c in contents]
    tpools = [{k: torch.tensor(c[k]) for k in c} for c in contents]
    rows = np.zeros((2, mb), np.int32)
    rows[0, :5] = [3, 4, 5, 9, 10]             # cached 3 blocks, own 2
    rows[1, :6] = [3, 4, 5, 6, 11, 12]         # cached 4 blocks, own 2
    t_cached = np.array([12, 16], np.int32)
    t_real = np.array([5, 7], np.int32)
    toks = np.zeros((2, 8), np.int32)
    toks[0, :5] = rng.randint(0, 64, 5)
    toks[1, :7] = rng.randint(0, 64, 7)
    zeros = np.zeros(2, np.uint32)
    want, jnew = j_make_prefill_cached(jcfg, bs, 2)(
        jp, jpools, jnp.asarray(rows), jnp.asarray(toks),
        jnp.asarray(t_real), jnp.asarray(t_cached), jnp.asarray(zeros),
        jnp.asarray(zeros), jnp.zeros(2, jnp.float32),
        jnp.zeros(2, jnp.int32), jnp.ones(2, jnp.float32))
    got = _make_prefill_cached(tcfg, bs)(
        tp, tpools, torch.tensor(rows), torch.tensor(toks),
        torch.tensor(t_real), torch.tensor(t_cached), zeros, zeros,
        np.zeros(2, np.float32), np.zeros(2, np.int32),
        np.ones(2, np.float32))
    assert got.tolist() == np.asarray(want).tolist()
    written = {9, 10, 11, 12}                  # 12+5 -> 9, 10; 16+7 -> 11, 12
    for layer in range(tcfg.n_layers):
        for k in ("k", "v"):
            t, j = tpools[layer][k].numpy(), np.asarray(jnew[layer][k])
            np.testing.assert_allclose(t[1:], j[1:], rtol=1e-5, atol=1e-5)
            for blk in range(1, nb):
                if blk not in written:        # prefix and idle blocks
                    np.testing.assert_array_equal(t[blk],
                                                  contents[layer][k][blk])
            assert not np.array_equal(t[9], contents[layer][k][9])
    # the suffix read the prefix: other contents there give other K/V in
    # the second layer (its input went through the first layer's attend)
    tpools2 = [{k: torch.tensor(c[k]) for k in c} for c in contents]
    tpools2[0]["v"][3] += 1.0
    _make_prefill_cached(tcfg, bs)(
        tp, tpools2, torch.tensor(rows), torch.tensor(toks),
        torch.tensor(t_real), torch.tensor(t_cached), zeros, zeros,
        np.zeros(2, np.float32), np.zeros(2, np.int32),
        np.ones(2, np.float32))
    assert not torch.allclose(tpools2[1]["k"][9], tpools[1]["k"][9])
    # the port's pools come from init_paged_pools with the JAX layout
    assert init_paged_pools(tcfg, nb, bs)[0]["k"].shape == \
        j_init_pools(jcfg, nb, bs)[0]["k"].shape
