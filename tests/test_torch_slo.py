"""The port's request journal and SLO evaluation (serving/slo.py, the
engine's hooks, GET /requests) against the JAX package's, on the CPU.

The math is held equal to JAX's functions on the same synthetic records
(the same float operations, so equal, not close).  The lifecycle tests
run the port's engine and server: preemption keeps the original arrival
and counts on the record, and ``/requests`` carries the uids the server
replied with.  The server binds port 0 on 127.0.0.1.
"""
import json
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.models import gpt as JG
from kungfu_tpu.serving import DecodeEngine as JEngine
from kungfu_tpu.serving import Request as JRequest
from kungfu_tpu.serving import slo as JS
from kungfu_tpu_torch.convert import params_from_jax
from kungfu_tpu_torch.models import gpt as TG
from kungfu_tpu_torch.serving import DecodeEngine, Request, ServingServer
from kungfu_tpu_torch.serving import slo as TS

REPO = Path(__file__).resolve().parents[1]
# tests/test_slo.py's model
MODEL = dict(vocab_size=89, d_model=16, n_heads=4, n_layers=2, d_ff=32,
             max_seq=64)


@pytest.fixture(scope="module")
def models():
    jcfg = JG.GPTConfig(dtype=jnp.float32, **MODEL)
    tcfg = TG.GPTConfig(dtype=torch.float32, **MODEL)
    jp = JG.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _records(mod, seed, n=12):
    """The same synthetic lifecycles as ``mod.RequestRecord``s: some
    unfinished, some with one output token, latencies 10 ms - 3 s."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        arrival = float(rng.uniform(0, 5))
        r = mod.RequestRecord(uid=i, arrival_t=arrival, prompt_tokens=4)
        r.admit_t = arrival + float(rng.uniform(0, 0.5))
        r.first_token_t = r.admit_t + float(rng.uniform(0.01, 2.5))
        if i % 5 != 4:                         # every fifth is still open
            r.finish_t = r.first_token_t + float(rng.uniform(0, 3))
            r.outcome = "finish"
        r.output_tokens = int(rng.randint(1, 40))
        r.queue_wait_s = float(rng.uniform(0, 0.3))
        out.append(r)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_record_latencies_match_jax(seed):
    for t, j in zip(_records(TS, seed), _records(JS, seed)):
        for name in ("ttft_ms", "tpot_ms", "e2e_ms"):
            assert getattr(t, name)() == getattr(j, name)(), name
        assert t.phase_s() == j.phase_s()
        assert t.to_dict() == j.to_dict()
        for obj in TS.OBJECTIVES:
            assert t.value_ms(obj) == j.value_ms(obj)


@pytest.mark.parametrize("compliance,percentile",
                         [(1.0, 0.9), (0.9, 0.9), (0.75, 0.9), (0.0, 0.9),
                          (0.5, 0.95), (0.99, 0.999), (0.3, 1.0)])
def test_burn_rate_matches_jax(compliance, percentile):
    assert TS.burn_rate(compliance, percentile) == \
        JS.burn_rate(compliance, percentile)


@pytest.mark.parametrize("window,pct,targets",
                         [(4, 0.9, (100.0, 50.0, 1000.0)),
                          (8, 0.95, (2000.0, 200.0, 10000.0)),
                          (64, 0.5, (500.0, 0.0, 3000.0))])
def test_evaluate_matches_jax(window, pct, targets):
    ttft, tpot, e2e = targets
    tslos = TS.default_slos(ttft, tpot, e2e, pct, window)
    jslos = [JS.SLO(s.objective, s.target_ms, s.percentile, s.window)
             for s in tslos]
    assert [s.objective for s in tslos] == \
        [o for o, t in zip(TS.OBJECTIVES, targets) if t > 0]
    for seed in range(3):
        assert TS.evaluate(_records(TS, seed), tslos) == \
            JS.evaluate(_records(JS, seed), jslos)


def test_defaults_are_the_jax_knob_defaults():
    env = {}
    want = [(s.objective, s.target_ms, s.percentile, s.window)
            for s in JS.load_slos(env)]
    assert [(s.objective, s.target_ms, s.percentile, s.window)
            for s in TS.default_slos()] == want
    j = TS.RequestJournal()
    assert j._ring.maxlen == 1024 and j._max_bytes == 16_000_000
    assert j.sink_path is None


@pytest.mark.parametrize(
    "path", sorted((REPO / "kungfu_tpu_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py"], ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_source_reads_a_knob(path):
    """The JAX journal reads its settings from KFT_SLO_* variables; the
    port takes constructor arguments and reads no KFT_* variable."""
    assert "KFT_" not in path.read_text(), path.relative_to(REPO)


def _feed(journal, n):
    for i in range(n):
        journal.on_submit(i, float(i), 4)
        journal.on_admit(i, i + 0.01, slot=0, prefix_reused=0, wait_s=0.01)
        journal.on_first_token(i, i + 0.02)
        journal.on_finish(i, i + 0.05, output_tokens=4)


def test_journal_ring_bound_and_jsonl_rotation(tmp_path):
    j = TS.RequestJournal(ring=4, sink_dir=str(tmp_path), max_bytes=1,
                          slos=[TS.SLO("ttft", 100.0, 0.9, 4)])
    _feed(j, 40)
    assert [r.uid for r in j.finished()] == [36, 37, 38, 39]
    # max_bytes clamps at 4096: 40 records overflow it, one rotated
    # generation exists, and both streams open with an anchor
    rotated = tmp_path / (j.sink_path.split("/")[-1] + ".1")
    assert rotated.exists(), list(tmp_path.iterdir())
    for path in (j.sink_path, str(rotated)):
        first = json.loads(open(path).readline())
        assert first["kind"] == "anchor" and "wall" in first
    lines = [json.loads(ln) for ln in open(j.sink_path) if ln.strip()]
    assert lines[-1]["uid"] == 39 and lines[-1]["ttft_ms"] is not None
    j.close()


@pytest.mark.parametrize("n", [0, 1, 3, 64])
def test_snapshot_matches_jax(tmp_path, n):
    """The same events into both journals give the same snapshot (``n``
    caps the finished tail; 0 keeps JAX's whole-ring reading)."""
    slos = [("ttft", 25.0, 0.9, 4), ("e2e", 60.0, 0.5, 8)]
    t = TS.RequestJournal(ring=6, slos=[TS.SLO(*s) for s in slos])
    jj = JS.RequestJournal(ring=6, sink_dir=str(tmp_path), env={},
                           slos=[JS.SLO(*s) for s in slos])
    for journal in (t, jj):
        _feed(journal, 9)
        journal.on_submit(99, 50.0, 3)
        journal.on_admit(99, 50.5, slot=1, prefix_reused=32, wait_s=0.5)
    assert t.snapshot(n) == jj.snapshot(n)
    jj.close()


def test_journal_evict_open_closes_dangling():
    j = TS.RequestJournal(ring=8, slos=[TS.SLO("ttft", 100.0, 0.9, 4)])
    j.on_submit(1, 0.0, 4)
    j.on_submit(2, 0.0, 4)
    evicted = j.evict_open("test-teardown")
    assert {r.uid for r in evicted} == {1, 2}
    assert all(r.outcome == "evict" and r.finish_t is not None
               for r in j.finished())
    assert j.snapshot()["open"] == []
    assert j.evict_open() == []


def test_preemption_keeps_original_arrival_and_counts(models):
    """tests/test_slo.py's forced preemption (9 usable blocks of 4 cannot
    hold three full-length sequences): the journal keeps the original
    arrival, counts the preemptions per uid as the JAX journal does, and
    every request still finishes."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.RandomState(5)
    reqs = [dict(uid=i, prompt=rng.randint(0, 89, 8).tolist(), max_new=12)
            for i in range(3)]
    kw = dict(num_slots=3, block_size=4, num_blocks=10, prompt_buckets=(8,))
    jeng = JEngine(jp, jcfg, attend="gather", **kw)
    want = jeng.run([JRequest(**r) for r in reqs])
    eng = DecodeEngine(tp, tcfg, device="cpu", **kw)
    got = eng.run([Request(**r) for r in reqs])
    assert got == want and eng.stats.preemptions >= 1
    done = {r.uid: r for r in eng.journal.finished()}
    jdone = {r.uid: r for r in jeng.journal.finished()}
    assert set(done) == {0, 1, 2}
    assert {u: r.preemptions for u, r in done.items()} == \
        {u: r.preemptions for u, r in jdone.items()}
    preempted = [r for r in done.values() if r.preemptions > 0]
    assert preempted
    for r in preempted:
        assert r.admit_t > r.arrival_t
        assert r.queue_wait_s > 0.0
        assert r.outcome == "finish"
        assert r.first_token_t is not None
        assert r.arrival_t <= r.first_token_t <= r.finish_t
        assert r.output_tokens == 12


@pytest.fixture()
def served(models):
    eng = DecodeEngine(models[3], models[2], device="cpu", num_slots=2,
                       block_size=4, num_blocks=16, prompt_buckets=(8,),
                       decode_chunk=2)
    eng.journal = TS.RequestJournal(slos=TS.default_slos(window=8))
    srv = ServingServer(eng, host="127.0.0.1", port=0).start()
    yield srv
    srv.close()


def _get(srv, path):
    with urllib.request.urlopen(f"http://{srv.host}:{srv.port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _post(srv, payload):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_requests_endpoint_carries_the_server_uids(served):
    srv = served
    r1 = _post(srv, {"prompt": [1, 2, 3, 4], "max_new": 4})
    r2 = _post(srv, {"prompt": [5, 6, 7], "max_new": 3})
    uids = {r1["uid"], r2["uid"]}
    assert len(uids) == 2
    snap = _get(srv, "/requests?n=8")
    fin = {rec["uid"]: rec for rec in snap["finished"]}
    assert uids <= set(fin) and snap["open"] == []
    for uid in uids:
        rec = fin[uid]
        assert rec["outcome"] == "finish"
        assert rec["ttft_ms"] is not None and rec["ttft_ms"] > 0
        assert rec["e2e_ms"] >= rec["ttft_ms"]
    assert fin[r1["uid"]]["output_tokens"] == len(r1["tokens"])
    assert snap["slo"]["ttft"]["n"] == 2 and snap["slo"]["ttft"]["window"] == 8
    assert len(_get(srv, "/requests?n=1")["finished"]) == 1
    assert len(_get(srv, "/requests?n=bad")["finished"]) == 2
    journal = srv.engine.journal
    journal.on_submit(777, 0.0, 1)            # in flight at close
    srv.close()
    rec = {r.uid: r for r in journal.finished()}[777]
    assert rec.outcome == "evict"
