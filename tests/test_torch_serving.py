"""The port's serving engine against the JAX engine, on the CPU in f32.

The contract is the JAX engine's: greedy tokens equal the plain decoder's
for every request, through grouped bucketed prefill, slot reuse, chunked
decode, preemption with replay, speculative verify and the int8 pool.
Both engines get the same weights (``params_from_jax``) and requests,
and their tokens must be identical.
"""
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.models import gpt as JG
from kungfu_tpu.serving import DecodeEngine as JEngine
from kungfu_tpu.serving import Request as JRequest
from kungfu_tpu.serving.engine import _filter_logits as j_filter_logits
from kungfu_tpu_torch.convert import params_from_jax
from kungfu_tpu_torch.models import gpt as TG
from kungfu_tpu_torch.serving import DecodeEngine, Request, ServingServer
from kungfu_tpu_torch.serving.engine import (_filter_logits, _propose_draft,
                                             _Running)

SMALL = dict(vocab_size=97, d_model=16, n_heads=4, n_layers=2, d_ff=32,
             max_seq=64)
CFGS = {"wpe": dict(SMALL),
        "rope+gqa": dict(SMALL, n_kv_heads=2, rope=True, mlp="swiglu")}


def _models(name, seed=0):
    jcfg = JG.GPTConfig(dtype=jnp.float32, **CFGS[name])
    tcfg = TG.GPTConfig(dtype=torch.float32, **CFGS[name])
    jp = JG.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg)


def _requests(seed, n, plen=(2, 14), new=(1, 9), **kw):
    rng = np.random.RandomState(seed)
    return [dict(uid=i, prompt=rng.randint(0, 97, int(rng.randint(*plen)))
                 .tolist(), max_new=int(rng.randint(*new)), **kw)
            for i in range(n)]


def _both(name, reqs, port_kw=None, int8=False, **kw):
    """Run the same requests through the JAX engine (gather attend) and
    the port's engine under each of ``port_kw``'s settings; returns
    (list of port results, jax results, last port engine, params, cfg)."""
    jcfg, jp, tcfg, tp = _models(name)
    jeng = JEngine(jp, jcfg, attend="gather",
                   kv_dtype=jnp.int8 if int8 else None, **kw)
    want = jeng.run([JRequest(**r) for r in reqs])
    gots = []
    for extra in port_kw or [{}]:
        eng = DecodeEngine(tp, tcfg, device="cpu",
                           kv_dtype=torch.int8 if int8 else None,
                           **kw, **extra)
        gots.append(eng.run([Request(**r) for r in reqs]))
        assert eng.stats.preemptions == jeng.stats.preemptions
        assert eng.stats.prefills == jeng.stats.prefills
    return gots, want, eng, tp, tcfg


def _generate(tp, tcfg, prompt, n):
    return TG.generate(tp, tcfg, torch.tensor([prompt]), n)[0].tolist()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_engine_matches_jax_engine_with_slot_reuse(name):
    """7 requests through 3 slots, chunk 2: the port's engine gives the
    JAX engine's tokens and the plain decoder's, through either attend
    (on the CPU "fused" runs the kernel wrapper's plain version)."""
    reqs = _requests(3, 7)
    gots, want, eng, tp, tcfg = _both(
        name, reqs, port_kw=[{"attend": "gather"}, {"attend": "fused"}],
        num_slots=3, block_size=4, num_blocks=32, prompt_buckets=(8, 16),
        decode_chunk=2)
    assert gots == [want, want]
    for r in reqs:
        assert want[r["uid"]] == _generate(tp, tcfg, r["prompt"],
                                           r["max_new"]), r["uid"]
    assert len(eng._free) == eng._total_blocks


def test_engine_matches_jax_generate():
    jcfg, jp, tcfg, tp = _models("rope+gqa")
    reqs = _requests(4, 3)
    got = DecodeEngine(tp, tcfg, device="cpu", num_slots=2, block_size=4,
                       num_blocks=16, prompt_buckets=(16,)).run(
        [Request(**r) for r in reqs])
    for r in reqs:
        want = np.asarray(JG.generate(jp, jcfg, jnp.asarray([r["prompt"]],
                                                            jnp.int32),
                                      r["max_new"]))[0].tolist()
        assert got[r["uid"]] == want


def test_preemption_replays_like_jax():
    """A pool too small for all admitted requests forces preemption; the
    replay matches, and streamed tokens arrive once and in order."""
    reqs = _requests(5, 3, plen=(8, 9), new=(12, 13))
    emitted = {}
    on_tokens = (lambda uid, toks: emitted.setdefault(uid, []).extend(toks))
    gots, want, eng, _, _ = _both(
        "wpe", reqs, port_kw=[{}, {"on_tokens": on_tokens}], num_slots=3,
        block_size=4, num_blocks=10, prompt_buckets=(8,))
    assert eng.stats.preemptions >= 1
    assert gots == [want, want]
    assert eng.stats.tokens_out == sum(len(t) for t in want.values())
    assert emitted == want


def test_speculative_matches_jax_engine():
    """speculative=2 on repetitive prompts: lossless, and the same
    acceptance accounting as the JAX engine."""
    rng = np.random.RandomState(6)
    reqs = [dict(uid=i, prompt=(rng.randint(0, 5, 4).tolist() * 3)[:10],
                 max_new=int(rng.randint(4, 12))) for i in range(4)]
    jcfg, jp, tcfg, tp = _models("rope+gqa")
    kw = dict(num_slots=2, block_size=4, num_blocks=32,
              prompt_buckets=(16,), speculative=2)
    jeng = JEngine(jp, jcfg, attend="gather", **kw)
    want = jeng.run([JRequest(**r) for r in reqs])
    for attend in ("gather", "fused"):
        eng = DecodeEngine(tp, tcfg, device="cpu", attend=attend, **kw)
        got = eng.run([Request(**r) for r in reqs])
        assert got == want, attend
        assert eng.stats.spec_accepted == jeng.stats.spec_accepted
    for r in reqs:
        assert got[r["uid"]] == _generate(tp, tcfg, r["prompt"],
                                          r["max_new"])


def test_int8_pool_matches_jax_int8_engine():
    reqs = _requests(8, 5)
    gots, want, eng, _, _ = _both(
        "rope+gqa", reqs, port_kw=[{"attend": "gather"},
                                   {"attend": "fused"}],
        int8=True, num_slots=3, block_size=4, num_blocks=32,
        prompt_buckets=(8, 16), decode_chunk=3)
    assert eng.pools[0]["k"].dtype == torch.int8
    assert gots == [want, want]


def test_quantize_kv_rounds_like_jax():
    """Half-way values round to even, zero rows get scale 0 and divide by
    max(scale, 1e-30), exactly as the JAX cache does."""
    from kungfu_tpu.serving.cache import quantize_kv as jq
    from kungfu_tpu_torch.serving.cache import quantize_kv as tq
    kv = np.zeros((3, 8), np.float32)
    kv[0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 0.0]   # scale 1.0
    kv[1] = [-63.5, 0.25, 0.75, 0, 0, 0, 0, 0]             # scale 0.5
    got = [t.numpy() for t in tq(torch.from_numpy(kv))]
    want = [np.asarray(t) for t in jq(jnp.asarray(kv))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][2] == 0.0 and not got[0][2].any()


def test_pool_write_at_routes_past_the_table_to_scratch():
    """Verify positions past the table's width go to scratch, never
    clamped into the last (live) column -- the same pool as JAX's."""
    from kungfu_tpu.serving.cache import pool_write_at as jw
    from kungfu_tpu_torch.serving.cache import pool_write_at as tw
    rng = np.random.RandomState(9)
    S, Q, KVH, Dh, bs, MB, N = 2, 4, 2, 4, 4, 3, 8
    tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    qpos = np.array([[9, 10, 11, 12], [3, 4, 5, 6]], np.int32)
    k = rng.randn(S, Q, KVH, Dh).astype(np.float32)
    v = rng.randn(S, Q, KVH, Dh).astype(np.float32)
    pool = {"k": np.zeros((N, bs, KVH, Dh), np.float32),
            "v": np.zeros((N, bs, KVH, Dh), np.float32)}
    want = jw({n: jnp.asarray(a) for n, a in pool.items()},
              jnp.asarray(tables), jnp.asarray(qpos), jnp.asarray(k),
              jnp.asarray(v), bs)
    got = tw({n: torch.from_numpy(a.copy()) for n, a in pool.items()},
             torch.from_numpy(tables), torch.from_numpy(qpos),
             torch.from_numpy(k), torch.from_numpy(v), bs)
    # position 12 of slot 0 is past the table (MB * bs = 12): scratch
    np.testing.assert_array_equal(got["k"][3, 3].numpy(), k[0, 2])
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name][1:].numpy(),
                                      np.asarray(want[name])[1:])


def test_pool_attend_queries_honours_only_the_base_position():
    """A qpos that is not pos + arange(Q) gives the base-derived answer,
    as in JAX, through both the gather and the fused (plain) paths."""
    from kungfu_tpu.serving.cache import pool_attend_queries as ja
    from kungfu_tpu_torch.serving.cache import pool_attend_queries as ta
    rng = np.random.RandomState(10)
    S, Q, H, KVH, Dh, bs, MB = 2, 3, 4, 2, 8, 4, 3
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    pool = {n: rng.randn(7, bs, KVH, Dh).astype(np.float32)
            for n in ("k", "v")}
    q = rng.randn(S, Q, H, Dh).astype(np.float32)
    bad = np.array([[2, 9, 0], [5, 5, 5]], np.int32)    # not consecutive
    good = bad[:, :1] + np.arange(Q, dtype=np.int32)[None]
    want = np.asarray(ja(jnp.asarray(q), {n: jnp.asarray(a) for n, a in
                                          pool.items()},
                         jnp.asarray(tables), jnp.asarray(bad),
                         mode="gather"))
    tpool = {n: torch.from_numpy(a) for n, a in pool.items()}
    for mode in ("gather", "fused"):
        for qpos in (bad, good):
            got = ta(torch.from_numpy(q), tpool, torch.from_numpy(tables),
                     torch.from_numpy(qpos), mode=mode).numpy()
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_embed_gathers_f32_then_casts_and_greedy_ties_pick_first():
    from kungfu_tpu.serving.engine import _pick_tokens as j_pick
    from kungfu_tpu_torch.serving.engine import _pick_tokens as t_pick
    jcfg, jp, tcfg, tp = _models("wpe")
    bj = JG.GPTConfig(**{**CFGS["wpe"], "dtype": jnp.bfloat16})
    bt = TG.GPTConfig(**{**CFGS["wpe"], "dtype": torch.bfloat16})
    tok = np.array([[3, 96, 0]], np.int32)
    pos = np.array([[0, 5, 63]], np.int32)
    got = TG.embed(tp, torch.from_numpy(tok), torch.from_numpy(pos), bt)
    want = JG.embed(jp, jnp.asarray(tok), jnp.asarray(pos), bj)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    lg = np.zeros((2, 6), np.float32)
    lg[0, [1, 4]] = 2.0                              # tie: first wins
    lg[1, [0, 5]] = -1.0
    z = np.zeros(2)
    want = np.asarray(j_pick(jnp.asarray(lg), jnp.zeros(2, jnp.uint32),
                             jnp.zeros(2, jnp.uint32),
                             jnp.zeros(2, jnp.int32), jnp.zeros(2),
                             jnp.zeros(2, jnp.int32), jnp.ones(2)))
    got = t_pick(torch.from_numpy(lg), z, z, z, z, z, np.ones(2)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [1, 1]


@pytest.mark.parametrize("k,p", [(0, 1.0), (1, 1.0), (3, 1.0), (0, 0.5),
                                 (4, 0.7), (100, 1.0), (0, 1e-6)])
def test_filter_logits_matches_jax(k, p):
    lg = np.random.RandomState(0).randn(32).astype(np.float32) * 3
    lg[5] = lg[9] = lg.max()                          # a tie at the top
    got = _filter_logits(torch.from_numpy(lg), k, p).numpy()
    want = np.asarray(j_filter_logits(jnp.asarray(lg), k, p))
    np.testing.assert_array_equal(got, want)


def test_sampled_requests_are_scheduling_invariant():
    """A sampled request's tokens depend only on (uid, token index): the
    same across slot counts, chunk sizes, co-tenants and preemption."""
    _, _, tcfg, tp = _models("wpe")
    target = dict(uid=42, prompt=list(range(3, 9)), max_new=8,
                  temperature=1.3, top_k=20, top_p=0.9)
    noise = [dict(uid=100 + i, prompt=list(range(i, i + 7)), max_new=6,
                  temperature=0.7) for i in range(4)]

    preempted = []

    def run_with(extra, **kw):
        eng = DecodeEngine(tp, tcfg, device="cpu", block_size=4,
                           prompt_buckets=(8,), **kw)
        out = eng.run([Request(**r) for r in [target] + extra])[42]
        preempted.append(eng.stats.preemptions)
        return out

    solo = run_with([], num_slots=2, num_blocks=16, decode_chunk=1)
    assert run_with(noise, num_slots=3, num_blocks=32,
                    decode_chunk=4) == solo
    assert run_with(noise[:2], num_slots=3, num_blocks=7,
                    decode_chunk=2) == solo
    assert preempted[-1] >= 1                     # the squeeze preempted
    assert run_with([], num_slots=1, num_blocks=16, speculative=2) == solo
    other = DecodeEngine(tp, tcfg, device="cpu", num_slots=2, block_size=4,
                         num_blocks=16, prompt_buckets=(8,)).run(
        [Request(**dict(target, uid=42 + (1 << 32)))])
    assert list(other.values())[0] != solo        # both uid halves key it


def test_incremental_drafter_matches_reference():
    stream = np.random.RandomState(13).randint(0, 5, 40).tolist()
    for cut in range(3, 20):
        run = _Running(req=Request(uid=1, prompt=stream[:cut], max_new=99),
                       slot=0, blocks=[], out=[])
        for tok in stream[cut:cut + 12]:
            for K in (1, 3):
                assert run.draft(K) == _propose_draft(run.history(), K)
            run.out.append(tok)


def test_submit_validation():
    _, _, tcfg, tp = _models("wpe")
    eng = DecodeEngine(tp, tcfg, device="cpu", num_slots=2, block_size=4,
                       num_blocks=8, max_len=32, prompt_buckets=(8,))
    for bad in (dict(prompt=[1] * 8, max_new=30), dict(prompt=[1] * 9,
                                                       max_new=1),
                dict(prompt=[1] * 8, max_new=24), dict(prompt=[],
                                                       max_new=4),
                dict(prompt=[1, 2], max_new=0), dict(prompt=[1, 97],
                                                     max_new=2),
                dict(prompt=[1, 2], max_new=2, top_p=0.0)):
        with pytest.raises(ValueError):
            eng.submit(Request(uid=0, **bad))


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, tp = _models("wpe")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(tp, tcfg)
    from kungfu_tpu_torch.serving.__main__ import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--d-model", "16", "--n-heads", "4", "--n-layers", "1"])


def _post(srv, payload):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def test_server_generate_stream_and_stats():
    _, _, tcfg, tp = _models("wpe")
    eng = DecodeEngine(tp, tcfg, device="cpu", num_slots=3, block_size=4,
                       num_blocks=32, prompt_buckets=(8, 16),
                       decode_chunk=2)
    srv = ServingServer(eng, port=0).start()
    try:
        prompt = [5, 6, 7, 8]
        want = _generate(tp, tcfg, prompt, 6)
        out = json.loads(_post(srv, {"prompt": prompt, "max_new": 6}))
        assert out["tokens"] == want
        lines = [json.loads(x) for x in _post(
            srv, {"prompt": prompt, "max_new": 6,
                  "stream": True}).decode().splitlines()]
        assert lines[-1]["done"] and lines[-1]["tokens_total"] == 6
        assert sum((x["tokens"] for x in lines[:-1]), []) == want
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, {"prompt": [1] * 17, "max_new": 2})
        assert e.value.code == 422
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["tokens_out"] == 12 and stats["pending"] == 0
    finally:
        srv.close()
