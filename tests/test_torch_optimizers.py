"""The port's optimizer family against the JAX package's, on the CPU.

tests/test_optimizers.py's quadratic problem (least squares, d = 4, the
same generators; 240 rows so that 1, 2, 3 and 4 ranks split it) trains
through each wrapper in both packages from the same parameters and the
same global batch: JAX on ``flat_mesh(n)`` of virtual CPU devices, the
port on n gloo ranks, processes that meet through a FileStore.  The
four ranks are spawned once for the module and run every trajectory;
smaller groups are subgroups of them.  Each case compares the mean loss
of every step, every rank's parameters after every step against the
JAX lane of the same index, and the monitors' ``noise_scale`` /
``variance`` of every rank and step.

Tolerances (f32): losses and parameters 1e-5 relative + 1e-6 absolute
(the group mean sums in another order than XLA's psum, and the update
adds ``u`` and the pull to ``p`` one after the other where optax adds
them first; each is a rounding of ~1e-7, and the largest gap measured
is 9e-7 on parameters of order 1).  ``noise_scale`` and ``variance``
1e-4 relative + 1e-5 absolute: S_est divides the difference of two
nearly equal squared norms by 1/B_small - 1/B_big, so the rounding of
each norm (~6e-8 of it) grows by |g|^2 / (g2_small - g2_big); the
largest gap measured is 8e-6 relative, ~16x the norms' rounding.

The slice as a whole: ``kungfu_tpu_torch.examples.convergence_bert``'s
training loop at 2 ranks, from the flax ``bert_tiny`` weights carried
over by ``convert.load_flax_variables``, against the JAX example's loop
at 2 lanes for 10 steps: losses 1e-5 relative, ``noise_scale`` 1e-4
relative (the amplification above; measured 1.4e-7 and 7.5e-7).
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import kungfu_tpu.optimizers as kfopt
from kungfu_tpu.comm import collectives as JC
from kungfu_tpu.comm.mesh import flat_mesh as jflat_mesh
from kungfu_tpu.models import bert_tiny as jbert_tiny
from kungfu_tpu.monitor import _walk_monitor_states
from kungfu_tpu.ops import state as JS
from kungfu_tpu.training import (broadcast_variables as jbroadcast,
                                 build_train_step as jbuild, init_opt_state,
                                 replicate)
from kungfu_tpu_torch import optimizers as TO
from kungfu_tpu_torch.benchmarks.gpt import solo_group
from kungfu_tpu_torch.examples.ranks import launch
from kungfu_tpu_torch.ops import state as TS
from kungfu_tpu_torch.training import build_train_step

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ROWS, D, STEPS, BERT_STEPS = 240, 4, 12, 10
TOL = {"rtol": 1e-5, "atol": 1e-6}
STAT_TOL = {"rtol": 1e-4, "atol": 1e-5}

# name -> ranks, initial parameters ("same" on every rank, or "lanes":
# rank r's are the seed's + r), loss ("quad", or "zero": zero gradients)
# and the optimizer chain, outermost first: [kind, kwargs, inner] down to
# ["sgd" | "adam", lr]; gns's batch_size is the per-rank rows
SGD, ADAM = ["sgd", 0.05], ["adam", 1e-2]
CASES = {
    "sma": (4, "same", "quad", ["sma", {"alpha": 0.5}, SGD]),
    "sma_gns_local": (4, "same", "quad", [
        "sma", {"alpha": 0.1}, ["gns", {"apply": "local"}, ["sgd", 0.1]]]),
    "sma_gns_local_adam": (4, "same", "quad", [
        "sma", {"alpha": 0.1}, ["gns", {"apply": "local"}, ADAM]]),
    "gns_mean": (4, "same", "quad", ["gns", {}, ["sgd", 0.1]]),
    "variance": (4, "same", "quad", ["var", {}, ["sgd", 0.1]]),
    "adaptive": (4, "lanes", "quad", [
        "ada", {"change_step": 5, "alpha": 0.5}, SGD]),
    "adaptive_static_sma": (4, "lanes", "quad", [
        "ada", {"change_step": 5, "alpha": 0.5, "static_phase": "sma"},
        SGD]),
    "adaptive_static_sgd": (4, "lanes", "quad", [
        "ada", {"change_step": 5, "static_phase": "sgd"}, SGD]),
    "pair3": (3, "lanes", "quad", ["pair", {}, SGD]),
    "pair4": (4, "lanes", "quad", ["pair", {}, SGD]),
    "gossip4": (4, "lanes", "zero", ["pair", {}, ["sgd", 0.1]]),
}
# planted in the worker: pair4 with the exchange's direction reversed
FAULTS = {"pair4_reversed": "pair4"}
# the state_dict round trip and the monitor walk
WALK = ["gns", {"apply": "local"}, ["var", {}, ADAM]]


def make_data(seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(D, 1).astype(np.float32)
    x = rng.randn(ROWS, D).astype(np.float32)
    y = x @ w_true + 0.01 * rng.randn(ROWS, 1).astype(np.float32)
    return x, y


def fresh_params(seed=1):
    rng = np.random.RandomState(seed)
    return {"b": np.zeros((1,), np.float32),
            "w": rng.randn(D, 1).astype(np.float32)}


def jax_opt(spec, n):
    kind = spec[0]
    if kind == "sgd":
        return optax.sgd(spec[1])
    if kind == "adam":
        return optax.adam(spec[1])
    kw, inner = spec[1], jax_opt(spec[2], n)
    return {"sma": lambda: kfopt.synchronous_averaging(inner, **kw),
            "gns": lambda: kfopt.gradient_noise_scale(inner, ROWS // n,
                                                      **kw),
            "var": lambda: kfopt.gradient_variance(inner),
            "ada": lambda: kfopt.adaptive_sgd(inner, **kw),
            "pair": lambda: kfopt.pair_averaging(inner, n, **kw)}[kind]()


def _find(state, name):
    """The first field ``name`` in a JAX optimizer state."""
    if hasattr(state, name):
        return getattr(state, name)
    items = state.values() if isinstance(state, dict) else (
        state if isinstance(state, (tuple, list)) else ())
    for item in items:
        got = _find(item, name)
        if got is not None:
            return got
    return None


def jax_run(name):
    n, init, loss, spec = CASES[name]
    mesh = jflat_mesh(n=n)
    opt = jax_opt(spec, n)
    p0 = fresh_params()
    if init == "same":
        sp = replicate(p0, mesh)
    else:
        sp = jax.device_put(
            {k: np.stack([v + r for r in range(n)]) for k, v in p0.items()},
            NamedSharding(mesh, P("kf_peers")))
    st = init_opt_state(opt, sp, mesh)

    def quad(p, batch):
        x, y = batch
        return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)

    def zero(p, batch):
        return 0.0 * p["w"].sum()

    step = jbuild(quad if loss == "quad" else zero, opt, mesh, donate=False)
    batch = tuple(jnp.asarray(a) for a in make_data())
    out = {"loss": [], "params": [], "noise_scale": [], "variance": []}
    for _ in range(STEPS):
        sp, st, lv = step(sp, st, batch)
        out["loss"].append(float(np.asarray(lv)[0]))
        out["params"].append(np.concatenate(
            [np.asarray(sp[k]).reshape(n, -1) for k in ("b", "w")], axis=1))
        for stat in ("noise_scale", "variance"):
            v = _find(st, stat)
            if v is not None:
                out[stat].append(np.asarray(v).reshape(n))
    return {k: np.asarray(v) for k, v in out.items()}


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import optimizers as O
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.comm.mesh import flat_mesh, init_process_group_file
    from kungfu_tpu_torch.convert import load_flax_variables
    from kungfu_tpu_torch.examples import convergence_bert as CB
    from kungfu_tpu_torch.models.bert import bert_tiny
    from kungfu_tpu_torch.training import build_train_step

    torch.set_num_threads(1)
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    init_process_group_file(tmp + "/store", rank, 4, "gloo")
    groups = {n: flat_mesh(n=n) for n in (1, 2, 3, 4)}
    d = np.load(tmp + "/in.npz")
    plan = json.load(open(tmp + "/plan.json"))
    rows = plan["rows"]

    def build(spec, params, n, group):
        kind = spec[0]
        if kind == "sgd":
            return torch.optim.SGD(params, lr=spec[1])
        if kind == "adam":
            return torch.optim.Adam(params, lr=spec[1], betas=(0.9, 0.999),
                                    eps=1e-8)
        kw, inner = spec[1], build(spec[2], params, n, group)
        if kind == "sma":
            return O.synchronous_averaging(inner, group=group, **kw)
        if kind == "gns":
            return O.gradient_noise_scale(inner, rows // n, group=group, **kw)
        if kind == "var":
            return O.gradient_variance(inner, group=group)
        if kind == "ada":
            return O.adaptive_sgd(inner, group=group, **kw)
        return O.pair_averaging(inner, n, group=group, **kw)

    def quad(p, batch):
        x, y = batch
        return ((x @ p["w"] + p["b"] - y) ** 2).mean()

    def zero(p, batch):
        return 0.0 * p["w"].sum()

    batch = (torch.from_numpy(d["x"]), torch.from_numpy(d["y"]))

    def setup(n, init, loss, spec):
        off = rank if init == "lanes" else 0
        params = {k: torch.tensor(d[k] + off, requires_grad=True)
                  for k in ("b", "w")}
        opt = build(spec, [params["b"], params["w"]], n, groups[n])
        step = build_train_step(quad if loss == "quad" else zero, opt,
                                params, groups[n])
        return params, opt, step

    def flat(params):
        return np.concatenate([params[k].detach().numpy().reshape(-1)
                               for k in ("b", "w")])

    res = {}
    for name, (n, init, loss, spec) in plan["cases"].items():
        if rank >= n:
            continue
        reversed_ = name in plan["faults"]
        orig = C.ring_exchange
        if reversed_:
            C.ring_exchange = lambda x, g, s, n_: orig(x, g, -s, n_)
        params, opt, step = setup(n, init, loss, spec)
        rec = {"loss": [], "params": [], "noise_scale": [], "variance": []}
        for _ in range(plan["steps"]):
            rec["loss"].append(float(step(batch)))
            rec["params"].append(flat(params))
            for stat in ("noise_scale", "variance"):
                if hasattr(opt, stat):
                    rec[stat].append(float(getattr(opt, stat)))
        C.ring_exchange = orig
        for k, v in rec.items():
            res[name + "/" + k] = np.asarray(v)

    # the ring exchange at 3 ranks: rank i's value lands at i + shift
    if rank < 3:
        tree = [torch.tensor([rank, 10.0 + rank]), torch.tensor([100 + rank])]
        for s in (1, 2, -1):
            got = C.ring_exchange(tree, groups[3], s, 3)
            res[f"ring/{s}/f"], res[f"ring/{s}/i"] = (t.numpy() for t in got)

    # state_dict round trip and the monitor walk, 4 ranks
    params, opt, step = setup(4, "same", "quad", plan["walk"])
    for _ in range(3):
        step(batch)
    snap = {k: v.detach().clone() for k, v in params.items()}
    torch.save(opt.state_dict(), f"{tmp}/sd{rank}.pt")
    for _ in range(3):
        step(batch)
    params2 = {k: v.clone().requires_grad_(True) for k, v in snap.items()}
    opt2 = build(plan["walk"], [params2["b"], params2["w"]], 4, groups[4])
    opt2.load_state_dict(torch.load(f"{tmp}/sd{rank}.pt"))
    step2 = build_train_step(quad, opt2, params2, groups[4])
    for _ in range(3):
        step2(batch)
    res["roundtrip/params"] = np.stack([flat(params), flat(params2)])
    res["roundtrip/stats"] = np.array([
        [float(o.noise_scale), float(o.variance),
         int(o.gradient_noise_scale.step), int(o.gradient_variance.step)]
        for o in (opt, opt2)])

    # the slice as a whole: the convergence_bert loop at 2 ranks
    if rank < 2:
        model = bert_tiny(vocab_size=CB.VOCAB, max_len=CB.SEQ,
                          dtype=torch.float32)
        tree = {}
        for key in d.files:
            if key.startswith("bert/"):
                node = tree
                path = key.split("/")[1:]
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = d[key]
        load_flax_variables(model, tree)
        args = CB.parse_args(["--steps", str(plan["bert_steps"]),
                              "--device", "cpu"])
        out = CB.train(args, torch.device("cpu"), groups[2], model)
        res["bert/loss"] = np.asarray(out["losses"])
        res["bert/noise_scale"] = np.asarray(out["noise_scales"])
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")


def _flatten(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _bert_init():
    """The JAX example's model and initial parameters."""
    CB = _jax_example()
    model = jbert_tiny(vocab_size=CB.VOCAB, max_len=CB.SEQ,
                       dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, CB.SEQ),
                                                          jnp.int32),
                        train=False)
    return model, params


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_bert", REPO / "examples" / "convergence_bert.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every trajectory of the port, from four gloo ranks spawned once:
    one npz of results per rank."""
    tmp = tmp_path_factory.mktemp("optimizers")
    x, y = make_data()
    _, bert = _bert_init()
    np.savez(tmp / "in.npz", x=x, y=y, **fresh_params(),
             **_flatten(jax.tree_util.tree_map(np.asarray, bert), "bert"))
    plan = {"rows": ROWS, "steps": STEPS, "bert_steps": BERT_STEPS,
            "cases": {**CASES, **{f: CASES[c] for f, c in FAULTS.items()}},
            "faults": list(FAULTS), "walk": WALK}
    (tmp / "plan.json").write_text(json.dumps(plan))
    i, code = launch(
        [[sys.executable, "-c", WORKER, str(r), str(tmp)] for r in range(4)],
        dict(os.environ, PYTHONPATH=str(REPO)), REPO, 400, tmp)
    assert i is None, (code, (tmp / f"{i}.log").read_text())
    out = [dict(np.load(tmp / f"out{r}.npz")) for r in range(4)]
    out.append(tmp)
    return out


def _port_run(ranks, name):
    n = CASES[FAULTS.get(name, name)][0]
    return {k: np.stack([ranks[r][f"{name}/{k}"] for r in range(n)], axis=1)
            for k in ("loss", "params", "noise_scale", "variance")}


def _assert_matches(got, want):
    np.testing.assert_allclose(got["loss"][:, 0], want["loss"], **TOL)
    np.testing.assert_allclose(got["params"], np.stack(want["params"]),
                               **TOL)
    for stat in ("noise_scale", "variance"):
        assert got[stat].size == np.asarray(want[stat]).size, stat
        if got[stat].size:
            np.testing.assert_allclose(got[stat], np.stack(want[stat]),
                                       **STAT_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_trajectory_matches_jax(ranks, name):
    got, want = _port_run(ranks, name), jax_run(name)
    _assert_matches(got, want)
    n = CASES[name][0]
    if name.startswith("gns") or name.startswith("sma_gns"):
        assert np.all(np.isfinite(got["noise_scale"]))
    if name == "variance":
        assert np.all(got["variance"] >= 0) and got["variance"].max() > 0
    if name.startswith("sma"):                # the replicas stay apart
        assert not np.allclose(got["params"][-1, 0], got["params"][-1, -1])
    if name == "adaptive":                    # identical from the switch on
        for t in range(5, STEPS):
            np.testing.assert_allclose(got["params"][t, 0],
                                       got["params"][t, -1],
                                       rtol=1e-4, atol=1e-6)
    if name == "gossip4":                     # converges to the mean
        w = got["params"][-1, :, 1:]
        spread = np.arange(n).std()
        assert w.std(axis=0).max() < 0.05 * spread
        np.testing.assert_allclose(w.mean(axis=0), fresh_params()["w"][:, 0]
                                   + np.arange(n).mean(), rtol=1e-5)


def test_reversed_exchange_fails_the_comparison(ranks):
    got, want = _port_run(ranks, "pair4_reversed"), jax_run("pair4")
    with pytest.raises(AssertionError):
        _assert_matches(got, want)
    gap = np.abs(got["params"] - np.stack(want["params"])).max()
    assert gap > 100 * TOL["atol"], gap


def test_ring_exchange_lands_at_rank_plus_shift(ranks):
    mesh = jflat_mesh(n=3)
    for s in (1, 2, -1):
        fn = jax.jit(jax.shard_map(
            lambda v: JC.ring_exchange(v, "kf_peers", shift=s, n=3),
            mesh=mesh, in_specs=P("kf_peers"), out_specs=P("kf_peers")))
        want = np.asarray(fn(np.arange(3, dtype=np.float32)))
        for r in range(3):
            np.testing.assert_array_equal(ranks[r][f"ring/{s}/f"],
                                          [want[r], 10 + want[r]])
            np.testing.assert_array_equal(ranks[r][f"ring/{s}/i"],
                                          [100 + want[r]])
            assert want[r] == (r - s) % 3


def test_state_dict_round_trip(ranks):
    for r in range(4):
        p, stats = ranks[r]["roundtrip/params"], ranks[r]["roundtrip/stats"]
        np.testing.assert_array_equal(p[0], p[1])
        np.testing.assert_array_equal(stats[0], stats[1])
        assert stats[0][2] == stats[0][3] == 6
        assert stats[0][0] != 0 and stats[0][1] > 0


def test_monitor_walk_finds_both_gauges(ranks):
    """The reference's own walker (getattr, then dicts and lists) finds
    ``noise_scale`` and ``variance`` in the port's ``state_dict()`` as in
    the JAX state, and on the optimizer itself."""
    sd = torch.load(ranks[-1] / "sd0.pt")
    found = {}
    _walk_monitor_states(sd, found)
    assert set(found) == {"kungfu_tpu_grad_noise_scale",
                          "kungfu_tpu_grad_variance"}
    assert found["kungfu_tpu_grad_noise_scale"] == float(
        sd["gradient_noise_scale"].noise_scale)
    assert found["kungfu_tpu_grad_variance"] == float(
        sd["gradient_variance"].variance) > 0
    w = torch.zeros(2, requires_grad=True)
    with solo_group(CPU):
        opt = TO.synchronous_averaging(TO.gradient_noise_scale(
            TO.gradient_variance(torch.optim.SGD([w], lr=0.1)), 4,
            apply="local"))
        found = {}
        _walk_monitor_states(opt, found)
    assert found == {"kungfu_tpu_grad_noise_scale": 0.0,
                     "kungfu_tpu_grad_variance": 0.0}


def test_noise_scale_at_one_rank_is_exactly_zero():
    x, y = make_data()
    p0 = fresh_params()
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    with solo_group(CPU):
        opt = TO.gradient_noise_scale(torch.optim.SGD(
            [params["b"], params["w"]], lr=0.1), batch_size=ROWS)
        step = build_train_step(
            lambda p, b: ((b[0] @ p["w"] + p["b"] - b[1]) ** 2).mean(), opt,
            params)
        for _ in range(3):
            step((torch.from_numpy(x), torch.from_numpy(y)))
            assert float(opt.noise_scale) == 0.0
    mesh = jflat_mesh(n=1)
    jopt = kfopt.gradient_noise_scale(optax.sgd(0.1), batch_size=ROWS)
    sp = replicate(p0, mesh)
    st = init_opt_state(jopt, sp, mesh)
    jstep = jbuild(lambda p, b: jnp.mean((b[0] @ p["w"] + p["b"] - b[1])
                                         ** 2), jopt, mesh, donate=False)
    sp, st, _ = jstep(sp, st, (jnp.asarray(x), jnp.asarray(y)))
    assert float(np.asarray(st.noise_scale)[0]) == 0.0


def test_bad_arguments_raise():
    w = torch.zeros(2, requires_grad=True)
    with pytest.raises(ValueError, match="apply"):
        TO.gradient_noise_scale(torch.optim.SGD([w], lr=0.1), 4,
                                apply="bogus")
    with pytest.raises(ValueError, match="static_phase"):
        TO.adaptive_sgd(torch.optim.SGD([w], lr=0.1), 2, static_phase="x")
    with pytest.raises(ValueError, match="n must be"):
        TO.pair_averaging(torch.optim.SGD([w], lr=0.1), 0)
    with solo_group(CPU):
        with pytest.raises(ValueError, match="group has 1"):
            TO.pair_averaging(torch.optim.SGD([w], lr=0.1), 2)
        opt = TO.gradient_noise_scale(torch.optim.SGD([w], lr=0.1), 4)
        with pytest.raises(ValueError, match="already carries"):
            TO.gradient_noise_scale(opt, 4)
    assert TO.MonitorGradientNoiseScaleOptimizer is TO.gradient_noise_scale
    assert not hasattr(TO, "AsyncPairAverager")


def test_state_ops_match_jax():
    js, ts = JS.counter_init(5), TS.counter_init(5)
    for incr in (1, 3, 1):
        jc, js = JS.counter_update(js, incr)
        tc, ts = TS.counter_update(ts, incr)
        assert int(jc) == int(tc) and ts.count.dtype == torch.int32
    assert int(js.count) == int(ts.count) == 10
    xs = np.random.RandomState(0).randn(6).astype(np.float32)
    je, te = JS.ema_init(), TS.ema_init()
    before = te.value.clone()
    for x in xs:
        jv, je = JS.ema_update(je, x, alpha=0.8)
        tv, te = TS.ema_update(te, torch.tensor(x), alpha=0.8)
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-7)
    assert bool(te.initialized) and float(before) == 0.0
    jh, th = JS.ExponentialMovingAverage(0.8), TS.ExponentialMovingAverage(0.8)
    assert th.value is None
    for x in xs:
        assert th(float(x)) == jh(float(x))
    jcn, tcn = JS.Counter(2, 3), TS.Counter(2, 3)
    assert [tcn() for _ in range(4)] == [jcn() for _ in range(4)]


def test_convergence_bert_loop_matches_jax(ranks):
    """The JAX example's loop at 2 lanes, 10 steps, against the port's at
    2 ranks from the same weights and the same data stream."""
    CB = _jax_example()
    model, params = _bert_init()

    def loss_fn(p, batch):
        tokens, masked, is_masked = batch
        logits = model.apply(p, masked, train=True)
        nll = optax.softmax_cross_entropy_with_integer_labels(logits, tokens)
        return (nll * is_masked).sum() / jnp.maximum(is_masked.sum(), 1)

    opt = kfopt.synchronous_averaging(
        kfopt.gradient_noise_scale(optax.adam(1e-3), batch_size=8,
                                   apply="local"), alpha=0.1)
    mesh = jflat_mesh(n=2)
    sp = jbroadcast(replicate(params, mesh), mesh)
    st = init_opt_state(opt, sp, mesh)
    step = jbuild(loss_fn, opt, mesh, donate=False)
    bank, rng = CB.template_bank(), np.random.RandomState(0)
    losses, noise = [], []
    for _ in range(BERT_STEPS):
        batch = tuple(jnp.asarray(a) for a in CB.sample_batch(bank, rng, 16))
        sp, st, loss = step(sp, st, batch)
        losses.append(float(np.asarray(loss)[0]))
        noise.append(float(np.asarray(st.noise_scale)[0]))
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["bert/loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(ranks[r]["bert/noise_scale"], noise,
                                   rtol=1e-4)
    from kungfu_tpu_torch.examples import convergence_bert as TCB
    np.testing.assert_array_equal(TCB.template_bank(), CB.template_bank())


@pytest.mark.parametrize("module,args", [
    ("bert_sma_gns", ["--steps", "2"]),
    ("convergence_bert", ["--steps", "3", "--target", "100"]),
    ("pair_averaging", ["--steps", "3"]),
])
def test_example_runs_on_cpu_at_two_ranks(module, args):
    r = subprocess.run(
        [sys.executable, "-m", f"kungfu_tpu_torch.examples.{module}",
         "--device", "cpu", "--world", "2", *args], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines and lines[0].startswith("step "), r.stdout
    if module == "convergence_bert":
        rec = json.loads(lines[-1].removeprefix("CONVERGENCE "))
        assert rec["lanes"] == 2 and rec["reached"]
    if module == "pair_averaging":
        assert lines[-1].startswith("max |w - w_true|")
