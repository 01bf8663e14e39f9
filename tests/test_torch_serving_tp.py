"""Tensor-parallel serving of the port against the JAX engine, on the CPU
in f32.

The port runs one gloo process per tp rank (a world of 4 ranks, spawned
once for the module and joined through a ``FileStore``; a 2-rank case
runs on ranks 0-1 while ranks 2-3 only join the groups): rank 0 drives
the engine and the others follow its commands.  The JAX side runs the
same cases in this process on the conftest's virtual CPU devices, with
the same weights (``params_from_jax``) and requests.  Each case is named
after the JAX test it mirrors (tests/test_serving_tp.py,
test_weights_int8.py, test_kv_int8.py, test_speculative.py,
test_gpt_decode.py), and greedy tokens must be equal.  Sampled tokens
are compared with the port's own single-device engine: the port keeps
JAX's sampling discipline, not its random bits.
"""
import functools
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kungfu_tpu.models import gpt as JG
from kungfu_tpu.ops.quant import quantize_specs as j_quantize_specs
from kungfu_tpu.ops.quant import quantize_weights as j_quantize_weights
from kungfu_tpu.serving import DecodeEngine as JEngine
from kungfu_tpu.serving import Request as JRequest
from kungfu_tpu_torch.comm.mesh import ProcessMesh
from kungfu_tpu_torch.convert import params_from_jax
from kungfu_tpu_torch.examples.ranks import launch
from kungfu_tpu_torch.models import gpt as TG
from kungfu_tpu_torch.ops.quant import QuantizedTensor, quantize_weights
from kungfu_tpu_torch.parallel.threed import shard_params

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
# f32 on both sides: the tp sums and the gathered head change only the
# order of f32 additions
LOGIT_TOL = {"rtol": 1e-4, "atol": 1e-5}

CFG = dict(vocab_size=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq=64, rope=True)           # test_serving_tp.CFG
CFG4 = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, rope=True)                   # MHA, for tp 4
INT8W = dict(vocab_size=96, d_model=16, n_heads=4, n_layers=2, d_ff=32,
             max_seq=64, rope=True)   # test_weights_int8's tp_cfg
SPEC = dict(vocab_size=96, d_model=16, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=32, max_seq=96, rope=True)   # test_speculative's
PREFIX = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
              n_layers=2, d_ff=64, max_seq=128, rope=True)  # test_prefix
DECODE = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=2, d_ff=32,
              max_seq=32)                            # test_gpt_decode.CFG
BASE_KW = dict(block_size=4, prompt_buckets=(8, 16))


def _reqs(rng, n, max_prompt=12, max_new=6, vocab=128):
    """test_serving_tp._reqs."""
    return [dict(uid=i, prompt=rng.randint(
        0, vocab, int(rng.randint(2, max_prompt))).tolist(),
        max_new=int(rng.randint(1, max_new))) for i in range(n)]


def _int8w_reqs():
    rng = np.random.RandomState(7)
    out = []
    for i in range(4):
        prompt = rng.randint(0, INT8W["vocab_size"],
                             int(rng.randint(2, 10))).tolist()
        out.append(dict(uid=i, prompt=prompt,
                        max_new=int(rng.randint(1, 6))))
    out[1].update(temperature=0.7, top_k=9)
    return out


def _prefix_runs():
    """Prompts A B B A of 4 full blocks and a token, one at a time, one
    slot, 7 usable blocks: B's second run hits, A's second run misses
    (its blocks were evicted for B)."""
    rng = np.random.RandomState(8)
    a, b = (rng.randint(0, PREFIX["vocab_size"], 17).tolist()
            for _ in range(2))
    return [[dict(uid=i, prompt=p, max_new=3)]
            for i, p in enumerate((a, b, b, a))]


def _cases():
    """name -> case: world ``n``, model, JAX seed, engine settings, and
    the request batches (run one after the other)."""
    sd = _reqs(np.random.RandomState(3), 6)
    sd[2]["temperature"] = 0.7
    rng = np.random.RandomState(6)
    kv = [dict(uid=i, prompt=rng.randint(0, 128, int(rng.randint(2, 10)))
               .tolist(), max_new=3) for i in range(4)]
    rng = np.random.RandomState(13)
    spec = [dict(uid=i, prompt=rng.randint(0, 96, int(rng.randint(3, 10)))
                 .tolist(), max_new=5) for i in range(4)]
    return {
        "tp2-gqa": dict(n=2, cfg=CFG, seed=0, kw=dict(
            num_slots=2, num_blocks=32, decode_chunk=2),
            batches=[_reqs(np.random.RandomState(1), 5)]),
        "tp4-mha": dict(n=4, cfg=CFG4, seed=0, kw=dict(
            num_slots=2, num_blocks=32, decode_chunk=2),
            batches=[_reqs(np.random.RandomState(1), 5)]),
        "single_device": dict(n=2, cfg=CFG, seed=2, single=True, kw=dict(
            num_slots=3, num_blocks=32, decode_chunk=3), batches=[sd]),
        # 7 blocks, not the JAX test's 10: at 10 these requests are
        # never preempted
        "preemption": dict(n=2, cfg=CFG, seed=4, kw=dict(
            num_slots=3, num_blocks=7, decode_chunk=2),
            batches=[_reqs(np.random.RandomState(5), 4, max_prompt=10,
                           max_new=8)]),
        "weights_int8": dict(n=2, cfg=INT8W, seed=0, single=True, kw=dict(
            num_slots=2, num_blocks=32, decode_chunk=2, weights_int8=True),
            batches=[_int8w_reqs()]),
        "kv_int8": dict(n=2, cfg=CFG, seed=5, kw=dict(
            num_slots=2, num_blocks=24, decode_chunk=2, kv_int8=True),
            batches=[kv]),
        "speculative": dict(n=2, cfg=SPEC, seed=12, kw=dict(
            num_slots=2, num_blocks=64, speculative=3), batches=[spec]),
        "prefix": dict(n=2, cfg=PREFIX, seed=0, kw=dict(
            num_slots=1, num_blocks=8, prefill_group=1, prefix_cache=True,
            prompt_buckets=(8, 32)), batches=_prefix_runs()),
        "idle": dict(n=2, cfg=CFG, seed=0, idle_s=4.0, data_timeout_s=2.0,
                     kw=dict(num_slots=2, num_blocks=32, decode_chunk=2),
                     batches=[_reqs(np.random.RandomState(1), 2)]),
    }


LOGIT_PROMPTS = [[5, 17, 3, 99, 42], [7, 1, 8, 2, 6, 4, 5, 9, 2, 7, 11]]
GEN = dict(seed=4, batch=2, T=6, n_new=5)


def _gen_prompt():
    rng = np.random.RandomState(GEN["seed"])
    return rng.randint(0, DECODE["vocab_size"], (GEN["batch"], GEN["T"]))


WORKER = textwrap.dedent('''
    import json, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch.comm.mesh import (init_process_group_file,
                                            serving_mesh)
    from kungfu_tpu_torch.models import gpt as G
    from kungfu_tpu_torch.parallel import threed as T3
    from kungfu_tpu_torch.serving import DecodeEngine, Request
    from kungfu_tpu_torch.serving import engine as E

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    init_process_group_file(f"{tmp}/store", rank, world, "gloo",
                            timeout_s=120)
    plan = json.load(open(f"{tmp}/plan.json"))
    out = {}

    def cfg_of(d):
        return G.GPTConfig(dtype=torch.float32, **d)

    def engine(case, mesh):
        kw = dict(plan["base_kw"], **case["kw"])
        kw["prompt_buckets"] = tuple(kw["prompt_buckets"])
        if kw.pop("kv_int8", False):
            kw["kv_dtype"] = torch.int8
        params = torch.load(f"{tmp}/{case['params']}.pt")
        return DecodeEngine(params, cfg_of(case["cfg"]), device="cpu",
                            mesh=mesh, **kw)

    def run(eng, batches):
        res = {}
        for reqs in batches:
            got = eng.run([Request(**r) for r in reqs])
            res.update({str(k): v for k, v in got.items()})
        return res

    for name, case in plan["cases"].items():
        mesh = serving_mesh(case["n"], timeout_s=case.get("data_timeout_s"))
        if mesh is None:
            continue
        eng = engine(case, mesh)
        if rank:
            eng.follow()
            continue
        time.sleep(case.get("idle_s", 0.0))   # followers wait meanwhile
        rec = {"tokens": run(eng, case["batches"]),
               "stats": {k: getattr(eng.stats, k) for k in (
                   "preemptions", "prefix_hits", "prefix_tokens_reused",
                   "prefills", "spec_accepted")},
               "ranks": eng.stats.ranks}
        eng.close()
        if case.get("single"):
            rec["single"] = run(engine(case, None), case["batches"])
        out[name] = rec

    # indivisible heads: kv_heads 2 over 4 ranks
    mesh = serving_mesh(4)
    try:
        engine(plan["cases"]["tp2-gqa"], mesh)
        out["indivisible"] = "constructed"
    except ValueError as e:
        out["indivisible"] = str(e)

    # the prefill and first-decode logits of a tp-2 engine's programs,
    # sound and with the attention-output all-reduce skipped at layer 0
    mesh = serving_mesh(2)
    if mesh is not None:
        case = plan["cases"]["tp2-gqa"]
        eng = engine(case, mesh)
        cfg, prompts = eng.cfg, plan["logit_prompts"]

        def logits():
            n, T = len(prompts), 16
            rows = np.zeros((n, eng.max_blocks), np.int32)
            toks = np.zeros((n, T), np.int32)
            for g, p in enumerate(prompts):
                rows[g, :4] = [1 + 4 * g + j for j in range(4)]
                toks[g, :len(p)] = p
            t_real = np.asarray([len(p) for p in prompts], np.int32)
            dev, tp = eng._dev, eng.tp
            with torch.no_grad():
                x = E._prefill_features(eng.params, cfg, eng.bs, eng.pools,
                                        dev(rows), dev(toks), dev(t_real),
                                        tp=tp)
                first = E._last_logits(eng.params, x, dev(t_real),
                                       E._identity, tp)
                tok0 = torch.argmax(first, dim=-1).to(torch.int32)
                nxt = E._decode_core(eng.params, cfg, eng.bs, eng.pools,
                                     dev(rows), dev(t_real), tok0,
                                     "gather", E._identity, tp)
            return first.numpy(), tok0.numpy(), nxt.numpy()

        sound = logits()
        orig = G._decode_finish
        calls = [0]

        def skip_layer0_attn(layer, x, o, cfg, psum=None):
            calls[0] += 1
            if (calls[0] - 1) % cfg.n_layers == 0 and psum is not None:
                first = [True]

                def psum_(t, real=psum):
                    if first[0]:            # the attention output's
                        first[0] = False
                        return t
                    return real(t)
                return orig(layer, x, o, cfg, psum_)
            return orig(layer, x, o, cfg, psum)

        G._decode_finish = skip_layer0_attn
        fault = logits()
        G._decode_finish = orig
        if rank == 0:
            np.savez(f"{tmp}/logits.npz", prefill=sound[0], tok0=sound[1],
                     decode=sound[2], fault_prefill=fault[0],
                     fault_decode=fault[2])

    # make_tp_generate on a (1, 1, 4) mesh
    mesh = T3.mesh_3d(1, 1, 4)
    cfg = cfg_of(plan["gen_cfg"])
    full = torch.load(f"{tmp}/generate.pt")
    fn = T3.make_tp_generate(cfg, mesh, plan["gen_new"])
    got = fn(T3.shard_params(full, cfg, mesh),
             torch.tensor(plan["gen_prompt"]))
    out["generate"] = got.tolist()
    if rank == 0:
        json.dump(out, open(f"{tmp}/out.json", "w"))
    dist.destroy_process_group()
''')


@functools.lru_cache(maxsize=None)
def _jax_model(cfg_items, seed):
    jcfg = JG.GPTConfig(dtype=jnp.float32, **dict(cfg_items))
    return jcfg, JG.init_params(jax.random.PRNGKey(seed), jcfg)


def _jax_models(case):
    return _jax_model(tuple(sorted(case["cfg"].items())), case["seed"])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's results, from 4 gloo ranks that run while the tests
    compute the JAX side: ``port()`` waits for them."""
    tmp = tmp_path_factory.mktemp("serving_tp")
    cases = _cases()
    for name, case in cases.items():
        case["params"] = name
        _, jp = _jax_models(case)
        tcfg = TG.GPTConfig(dtype=torch.float32, **case["cfg"])
        torch.save(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   tcfg), tmp / f"{name}.pt")
    dcfg = JG.GPTConfig(dtype=jnp.float32, **DECODE)
    torch.save(params_from_jax(jax.tree_util.tree_map(
        np.asarray, JG.init_params(jax.random.PRNGKey(GEN["seed"]), dcfg)),
        TG.GPTConfig(dtype=torch.float32, **DECODE)), tmp / "generate.pt")
    plan = {"cases": cases, "base_kw": BASE_KW,
            "logit_prompts": LOGIT_PROMPTS, "gen_cfg": DECODE,
            "gen_new": GEN["n_new"], "gen_prompt": _gen_prompt().tolist()}
    (tmp / "plan.json").write_text(json.dumps(plan))
    argvs = [[sys.executable, "-c", WORKER, str(r), str(WORLD), str(tmp)]
             for r in range(WORLD)]
    done = {}
    th = threading.Thread(target=lambda: done.update(res=launch(
        argvs, dict(os.environ, PYTHONPATH=str(REPO)), REPO, 300, tmp)))
    th.start()

    def wait():
        th.join()
        i, code = done["res"]
        assert i is None, (code, (tmp / f"{i}.log").read_text()[-3000:])
        out = json.loads((tmp / "out.json").read_text())
        out["logits"] = dict(np.load(tmp / "logits.npz"))
        return out
    yield wait
    th.join()


def _mesh(devices, n):
    return Mesh(np.asarray(devices[:n]), ("tp",))


def _jax_run(case, mesh, int8=False):
    jcfg, jp = _jax_models(case)
    kw = dict(BASE_KW, **case["kw"])
    if kw.pop("kv_int8", False):
        kw["kv_dtype"] = jnp.int8
    eng = JEngine(jp, jcfg, mesh=mesh, attend="gather", **kw)
    res = {}
    for reqs in case["batches"]:
        res.update({str(k): v for k, v in eng.run(
            [JRequest(**r) for r in reqs]).items()})
    return res, eng.stats


def _greedy(case):
    return [r for reqs in case["batches"] for r in reqs
            if not r.get("temperature")]


@pytest.mark.parametrize("name", ["tp2-gqa", "tp4-mha"])
def test_tp_engine_matches_solo_decoder(port, devices, name):
    """The JAX tp engine's tokens (which its own test holds to the solo
    decoder's)."""
    case = _cases()[name]
    want, _ = _jax_run(case, _mesh(devices, case["n"]))
    got = port()[name]
    assert got["tokens"] == want
    # each rank's counters: no kernel on the CPU, time in its collectives
    assert len(got["ranks"]) == case["n"]
    assert all(rk["k5_launches"] == 0 and rk["collective_s"] > 0
               for rk in got["ranks"])


def test_tp_engine_matches_single_device_engine(port, devices):
    """tp 2 against one device, a sampled request included: every token
    equals the port's single-device engine's (the draw depends only on
    uid and index), and the greedy ones JAX's tp engine's (which its own
    test holds to its single-device engine's)."""
    case = _cases()["single_device"]
    want, _ = _jax_run(case, _mesh(devices, 2))
    got = port()["single_device"]
    assert got["tokens"] == got["single"]
    for r in _greedy(case):
        u = str(r["uid"])
        assert got["tokens"][u] == want[u], u


def test_tp_engine_preemption_replay(port, devices):
    case = _cases()["preemption"]
    want, jstats = _jax_run(case, _mesh(devices, 2))
    got = port()["preemption"]
    assert got["tokens"] == want
    assert got["stats"]["preemptions"] == jstats.preemptions >= 1


def test_tp_rejects_indivisible_heads(port, devices):
    with pytest.raises(ValueError, match="divisible"):
        case = _cases()["tp2-gqa"]
        jcfg, jp = _jax_models(case)
        JEngine(jp, jcfg, mesh=_mesh(devices, 8))
    assert "divisible" in port()["indivisible"]


def test_weights_int8_tp_matches_single_device(port, devices):
    """Quantized before sharding, scales split with their weights: the tp
    engine's tokens equal the single-device int8 engine's (a sampled
    top-k request included) and, greedy, JAX's."""
    case = _cases()["weights_int8"]
    want, _ = _jax_run(case, _mesh(devices, 2))
    got = port()["weights_int8"]
    assert got["tokens"] == got["single"]
    for r in _greedy(case):
        u = str(r["uid"])
        assert got["tokens"][u] == want[u], u


def test_int8_with_tensor_parallel(port, devices):
    case = _cases()["kv_int8"]
    want, _ = _jax_run(case, _mesh(devices, 2))
    assert port()["kv_int8"]["tokens"] == want


def test_spec_with_tensor_parallel(port, devices):
    case = _cases()["speculative"]
    want, jstats = _jax_run(case, _mesh(devices, 2))
    got = port()["speculative"]
    assert got["tokens"] == want
    assert got["stats"]["spec_accepted"] == jstats.spec_accepted


def test_prefix_cache_hit_and_eviction_under_tp(port, devices):
    """A B B A through one slot and 7 blocks: B's repeat hits (4 blocks
    reused), A's repeat misses (evicted); tokens equal JAX's tp
    engine's."""
    case = _cases()["prefix"]
    want, jstats = _jax_run(case, _mesh(devices, 2))
    got = port()["prefix"]
    assert got["tokens"] == want
    assert (got["stats"]["prefix_hits"], got["stats"]["prefix_tokens_reused"]
            ) == (jstats.prefix_hits, jstats.prefix_tokens_reused) == (1, 16)


def test_follower_outlives_an_idle_wait_past_the_data_timeout(port):
    """The followers wait 4 s for their first command, twice the data
    group's 2 s collective timeout: they wait on the control group,
    which has none to speak of, and then serve tp2-gqa's tokens (JAX's;
    the idle case's two requests are tp2-gqa's first two)."""
    out = port()
    assert out["idle"]["tokens"] == {u: out["tp2-gqa"]["tokens"][u]
                                     for u in ("0", "1")}


def _jax_logits(prompts, case):
    jcfg, jp = _jax_models(case)
    fwd = jax.jit(JG.forward, static_argnums=2)
    return [np.asarray(fwd(jp, jnp.asarray([p], jnp.int32), jcfg))[0, -1]
            for p in prompts]


def test_tp_logits_match_jax_and_a_planted_fault_fails(port):
    """Prefill and first-decode logits of the tp-2 programs against JAX's
    full forward (the prompt, then the prompt and its first token),
    within LOGIT_TOL; with the attention-output all-reduce skipped at
    layer 0 they miss it by far."""
    case = _cases()["tp2-gqa"]
    got = port()["logits"]
    want = np.stack(_jax_logits(LOGIT_PROMPTS, case))
    np.testing.assert_array_equal(got["tok0"], want.argmax(-1))
    want_next = np.stack(_jax_logits(
        [p + [int(t)] for p, t in zip(LOGIT_PROMPTS, got["tok0"])], case))
    for key, w in (("prefill", want), ("decode", want_next)):
        np.testing.assert_allclose(got[key], w, **LOGIT_TOL, err_msg=key)
        err = np.abs(got[f"fault_{key}"] - w).max()
        assert err > 100 * (LOGIT_TOL["atol"]
                            + LOGIT_TOL["rtol"] * np.abs(w).max()), (key, err)


def test_tp_generation_matches_single_device(port):
    dcfg = JG.GPTConfig(dtype=jnp.float32, **DECODE)
    jp = JG.init_params(jax.random.PRNGKey(GEN["seed"]), dcfg)
    prompt = jnp.asarray(_gen_prompt(), jnp.int32)
    want = np.asarray(JG.generate(jp, dcfg, prompt, GEN["n_new"]))
    got = np.asarray(port()["generate"])
    np.testing.assert_array_equal(got, want)


def test_quantize_specs_shards_match_jax_slices():
    """The port's quantize-then-shard against slices of JAX's quantized
    full tree, at tp 2 on a model whose scales split (wq's per-head
    scales at d_model 64, the FFN's and the head's columns) and stay
    whole (wo's, wm's)."""
    cfg = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2,
               n_layers=1, d_ff=128, max_seq=32, rope=True, mlp="swiglu")
    jcfg = JG.GPTConfig(dtype=jnp.float32, **cfg)
    tcfg = TG.GPTConfig(dtype=torch.float32, **cfg)
    jp = JG.init_params(jax.random.PRNGKey(3), jcfg)
    jq = j_quantize_weights(jp)
    jspecs = j_quantize_specs(jq, JG.param_specs(jcfg, "tp"))
    tq = quantize_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg))
    split = {"q": 0, "scale": 0}
    for rank in range(2):
        mesh = ProcessMesh(("tp",), (2,), (rank,), {})
        shards = shard_params(tq, tcfg, mesh)
        for key in ("wq", "wk", "wo", "wi", "wm"):
            want, spec = jq["layers"][0][key], jspecs["layers"][0][key]
            got = shards["layers"][0][key]
            assert isinstance(got, QuantizedTensor), key
            for part in ("q", "scale"):
                arr, ps = np.asarray(getattr(want, part)), getattr(spec, part)
                dims = [i for i, a in enumerate(ps) if a == "tp"]
                if dims:
                    arr = np.split(arr, 2, axis=dims[0])[rank]
                    split[part] += 1
                np.testing.assert_array_equal(
                    getattr(got, part).numpy(), arr, err_msg=f"{key}.{part}")
        head = shards["lm_head"]
        np.testing.assert_array_equal(head.q.numpy(), np.split(
            np.asarray(jq["lm_head"].q), 2, axis=1)[rank])
    assert split["scale"] and split["scale"] < split["q"]


# ------------------------------------------------------------------ CLI
def _serve(extra, log):
    proc = subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.serving", "--device", "cpu",
         "--port", "0", *extra], cwd=REPO, stdout=subprocess.PIPE,
        stderr=open(log, "w"), text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    line = proc.stdout.readline()
    assert line.startswith("SERVING ready on"), (line, Path(log).read_text())
    host, port = line.split()[-1].rsplit(":", 1)
    return proc, f"http://{host}:{port}/generate"


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_cli_kv_int8_and_tp(tmp_path):
    """``--tp 2 --backend gloo --device cpu --kv-int8`` serves over HTTP
    the tokens of ``--tp 0``, and stops its second rank on SIGTERM."""
    flags = ["--seed", "3", "--kv-int8", "--vocab", "64", "--d-model", "64",
             "--n-heads", "4", "--n-layers", "2", "--d-ff", "128",
             "--blocks", "64"]
    procs = {tp: _serve(flags + ["--tp", tp, "--backend", "gloo"],
                        tmp_path / f"tp{tp}.log") for tp in ("2", "0")}
    try:
        prompt = [4, 9, 2, 7]
        got = {tp: [_post(url, {"prompt": prompt, "max_new": 5})["tokens"]
                    for _ in range(2)] for tp, (_, url) in procs.items()}
    finally:
        for proc, _ in procs.values():
            proc.send_signal(signal.SIGTERM)
        for proc, _ in procs.values():
            proc.wait(timeout=60)
    assert got["2"][0] == got["2"][1] == got["0"][0]
    assert len(got["2"][0]) == 5 and all(0 <= t < 64 for t in got["2"][0])
    assert all(proc.returncode == 0 for proc, _ in procs.values()), \
        (tmp_path / "tp2.log").read_text()
