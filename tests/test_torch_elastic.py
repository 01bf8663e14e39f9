"""The port's elastic data plane against the JAX package's, on the CPU.

Trajectories: tests/test_elastic.py's quadratic problem (w of 4 x 1, 8
rows a rank, every step's batch seeded by the step count) trains on the
schedule 2:3,4:3,3:3 through the port's ``ElasticTrainer`` on gloo ranks,
processes that meet through versioned FileStores, and through JAX's
single-controller ``ElasticTrainer`` on virtual CPU devices, under
``synchronous_sgd(sgd)`` and ``synchronous_sgd(adam)``.  Every rank starts
from other parameters (the seed's + rank), so only rank 0's broadcast
makes the replicas equal; the newcomers of the grow join at version 1 and
rank 3 leaves at the shrink.  Tolerance: losses and parameters 1e-5
relative + 1e-6 absolute (f32; the mean over ranks sums in another order
than XLA's, as tests/test_torch_optimizers.py measured).  A newcomer
planted without rank 0's state (its own parameters and a fresh Adam)
must fail that comparison.

The slice as a whole: a 2-layer narrow GPT on the plain flash path grows
from 2 to 3 ranks under sync-SGD AdamW, from the JAX weights carried by
``convert.params_from_jax`` (the newcomer starts from other weights),
against JAX's ``ElasticTrainer`` on the same batches, at
tests/test_torch_training.py's f32 tolerances (losses 1e-5, parameters
2e-5 absolute).

The four ranks are spawned once for the module and run every case; the
rest (the config server's wire both ways, the cluster's JSON, the
rendezvous address, the schedule, data shard and policies, the npz and
checkpoint round trips, the top-level API, the example) runs here.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kungfu_tpu.optimizers as kfopt
from kungfu_tpu import checkpoint as JCK
from kungfu_tpu import distributed as JD
from kungfu_tpu.elastic import (ConfigServer as JServer, ElasticDataShard as
                                JShard, ElasticTrainer as JTrainer,
                                PolicyRunner as JRunner,
                                ScheduledResizePolicy as JSched,
                                StepSchedule as JSchedule,
                                fetch_config as jfetch, put_config as jput)
from kungfu_tpu.elastic.policy import GNSScalingPolicy as JGNS
from kungfu_tpu.models import gpt as JG
from kungfu_tpu.ops.chunked_ce import chunked_cross_entropy as jce
from kungfu_tpu.plan import Cluster as JCluster, HostList as JHostList
import kungfu_tpu_torch as kft
from kungfu_tpu_torch import checkpoint as TCK
from kungfu_tpu_torch import distributed as TD
from kungfu_tpu_torch.elastic import (ConfigServer, ElasticDataShard,
                                      GNSScalingPolicy, PolicyRunner,
                                      ScheduledResizePolicy, StepSchedule,
                                      fetch_config, put_config)
from kungfu_tpu_torch.examples.ranks import launch
from kungfu_tpu_torch.launcher import env as TE
from kungfu_tpu_torch.plan import Cluster, HostList, PeerList

REPO = Path(__file__).resolve().parents[1]
SCHEDULE = [[2, 3], [4, 3], [3, 3]]
GPT_SCHEDULE = [[2, 2], [3, 2]]
TOL = {"rtol": 1e-5, "atol": 1e-6}
W_TRUE = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
GPT = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=16, mlp="swiglu", rope=True, n_kv_heads=2)
GPT_LR, GPT_ROWS, CHUNK = 1e-3, 2, 32


def quad_batch(step, n, bs_per=8):
    """tests/test_elastic.py's ``batch_for``."""
    rng = np.random.RandomState(step)
    x = rng.randn(n * bs_per, 4).astype(np.float32)
    return x, x @ W_TRUE


def gpt_batch(step, n):
    toks = np.random.RandomState(100 + step).randint(
        0, GPT["vocab_size"], (GPT_ROWS * n, GPT["max_seq"])).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def w0():
    return np.random.RandomState(0).randn(4, 1).astype(np.float32)


WORKER = textwrap.dedent("""
    import json, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed as D
    from kungfu_tpu_torch.checkpoint import Checkpointer
    from kungfu_tpu_torch.convert import params_from_jax
    from kungfu_tpu_torch.elastic import ElasticTrainer, state
    from kungfu_tpu_torch.models import gpt as TG
    from kungfu_tpu_torch.ops.chunked_ce import chunked_cross_entropy
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.plan import PeerID, PeerList
    from kungfu_tpu_torch.utils.tree import tree_leaves

    torch.set_num_threads(1)
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    plan = json.load(open(tmp + "/plan.json"))
    d = np.load(tmp + "/in.npz", allow_pickle=False)
    PEERS = PeerList(PeerID("127.0.0.1", 31100 + i, i) for i in range(4))
    W_TRUE = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    cfg = TG.GPTConfig(dtype=torch.float32, **plan["gpt"])

    def quad(p, batch):
        x, y = batch
        return ((x @ p["w"] - y) ** 2).mean()

    def quad_batch(step, n):
        rng = np.random.RandomState(step)
        x = rng.randn(n * 8, 4).astype(np.float32)
        return torch.from_numpy(x), torch.from_numpy(x @ W_TRUE)

    def quad_state(p, ms, batch):
        x, y = batch
        mu = 0.9 * ms["mu"] + 0.1 * x.mean(0)
        return (((x - ms["mu"]) @ p["w"] - y) ** 2).mean(), {"mu": mu}

    def gpt_loss(p, batch):
        bt, by = batch
        feats = TG.forward_features(p, bt, cfg, attn="flash")
        return chunked_cross_entropy(feats, p["lm_head"], by,
                                     plan["chunk"]).mean()

    def gpt_batch(step, n):
        toks = np.random.RandomState(100 + step).randint(
            0, cfg.vocab_size, (plan["gpt_rows"] * n, cfg.max_seq))
        toks = torch.from_numpy(toks.astype(np.int32))
        return toks, torch.roll(toks, -1, dims=1)

    def factory(kind):
        def build(leaves, n):
            if kind in ("sgd", "state"):
                base = torch.optim.SGD(leaves, lr=0.1)
            elif kind == "adam":
                base = torch.optim.Adam(leaves, lr=1e-2, betas=(0.9, 0.999),
                                        eps=1e-8)
            else:
                base = torch.optim.AdamW(leaves, lr=plan["gpt_lr"],
                                         betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=1e-4)
            return synchronous_sgd(base)
        return build

    def versions(sizes):
        out, v = [], 0
        for i, s in enumerate(sizes):
            v += i > 0 and s != sizes[i - 1]
            out.append(v)
        return out

    def planted(own):
        # a newcomer that keeps its own parameters and a fresh optimizer
        real = D.broadcast_tree
        def fake(tree, group=None, root=0):
            got = real(tree, group, root)
            return {"params": own, "opt": None}
        return fake

    def run(name, kind, sched, fault=False):
        sizes = [s for s, _ in sched]
        vers = versions(sizes)
        join = next((i for i, s in enumerate(sizes) if s > rank), None)
        if join is None:
            return {}
        if kind == "gpt":
            if rank == 0:
                with open(tmp + "/gpt.pkl", "rb") as f:
                    params = params_from_jax(pickle.load(f), cfg)
            else:
                params = TG.init_params(torch.Generator().manual_seed(rank),
                                        cfg)
            batch_of = gpt_batch
            loss = gpt_loss
        else:
            params = {"w": torch.from_numpy(d["w0"] + rank)}
            batch_of, loss = quad_batch, quad
        mstate = None
        if kind == "state":
            loss, mstate = quad_state, {"mu": torch.full((4,), float(rank))}
        real = D.broadcast_tree
        if fault and join > 0:
            D.broadcast_tree = planted(params)
        tr = ElasticTrainer(loss, factory(kind), params, PEERS, rank,
                            init_size=sizes[join], version=vers[join],
                            rendezvous=f"{tmp}/rdzv_{name}",
                            init_model_state=mstate)
        D.broadcast_tree = real
        rec = {"loss": [], "step": [], "sync_bytes": [tr.last_sync_bytes]}
        for i in range(join, len(sched)):
            if i > join:
                tr.resize(sizes[i])
                if state.is_detached():
                    break
                rec["sync_bytes"].append(tr.last_sync_bytes)
            for _ in range(sched[i][1]):
                rec["step"].append(tr.step_count)
                rec["loss"].append(tr.step(batch_of(tr.step_count, tr.n)))
        if not state.is_detached():
            rec["final"] = np.concatenate([t.detach().numpy().reshape(-1)
                                           for t in tree_leaves(tr.params)])
            rec["samples"] = tr.trained_samples
            if mstate is not None:
                rec["mu"] = tr.current_model_state()["mu"].numpy()
            tr.shutdown()
        return {f"{name}/{k}": np.asarray(v) for k, v in rec.items()}

    res = {}
    for name, kind, fault in (("sgd", "sgd", False), ("adam", "adam", False),
                              ("adam_fault", "adam", True),
                              ("state", "state", False)):
        res.update(run(name, kind, plan["schedule"], fault))
    res.update(run("gpt", "gpt", plan["gpt_schedule"]))

    # resume across sizes: 4 ranks train 3 Adam steps and checkpoint; a
    # fresh 2-rank job restores and takes one more step
    ck = Checkpointer(tmp + "/ck")
    tr = ElasticTrainer(quad, factory("adam"),
                        {"w": torch.from_numpy(d["w0"] + rank)}, PEERS, rank,
                        rendezvous=tmp + "/rdzv_ck4")
    for _ in range(3):
        tr.step(quad_batch(tr.step_count, tr.n))
    res["ck/saved"] = np.asarray(tr.save_checkpoint(ck))
    ck.wait()
    res["ck/w4"] = tr.params["w"].numpy().copy()
    res["ck/samples4"] = np.asarray(tr.trained_samples)
    tr.shutdown()
    if rank < 2:
        tr = ElasticTrainer(quad, factory("adam"),
                            {"w": torch.from_numpy(d["w0"] - 5)}, PEERS,
                            rank, init_size=2, rendezvous=tmp + "/rdzv_ck2")
        res["ck/step"] = np.asarray(tr.restore_checkpoint(ck))
        res["ck/step_count"] = np.asarray(tr.step_count)
        res["ck/samples2"] = np.asarray(tr.trained_samples)
        res["ck/w2"] = tr.params["w"].numpy().copy()
        res["ck/exp_avg"] = tr.optimizer.state[tr.params["w"]][
            "exp_avg"].numpy().copy()
        res["ck/loss_next"] = np.asarray(tr.step(quad_batch(3, 2)))
        # sync_progress: an exact int64 MAX past 2^40
        tr.trained_samples = (1 << 40) + 3 if rank == 0 else 5
        res["progress"] = np.asarray(tr.sync_progress(), np.int64)
        tr.shutdown()
    np.savez(f"{tmp}/out{rank}.npz", **res)
""")


def _jgpt():
    cfg = JG.GPTConfig(dtype=jnp.float32, **GPT)
    return cfg, JG.init_params(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of the port, from four gloo ranks spawned once."""
    tmp = tmp_path_factory.mktemp("elastic")
    _, jp = _jgpt()
    np.savez(tmp / "in.npz", w0=w0())
    with open(tmp / "gpt.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jp), f)
    (tmp / "plan.json").write_text(json.dumps(
        {"schedule": SCHEDULE, "gpt_schedule": GPT_SCHEDULE, "gpt": GPT,
         "gpt_rows": GPT_ROWS, "gpt_lr": GPT_LR, "chunk": CHUNK}))
    i, code = launch(
        [[sys.executable, "-c", WORKER, str(r), str(tmp)] for r in range(4)],
        dict(os.environ, PYTHONPATH=str(REPO)), REPO, 300, tmp)
    assert i is None, (code, (tmp / f"{i}.log").read_text())
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(4)]


def jax_run(kind, schedule=SCHEDULE):
    """JAX's ElasticTrainer on the same schedule: the losses and lane 0's
    final parameters, flattened in sorted-key order."""
    if kind == "gpt":
        cfg, params = _jgpt()

        def loss_fn(p, batch):
            bt, by = batch
            feats = JG.forward_features(p, bt, cfg, attn="flash")
            return jce(feats, p["lm_head"].astype(cfg.dtype), by,
                       CHUNK).mean()
        opt = optax.adamw(GPT_LR)
        batch_of = gpt_batch
    else:
        params = {"w": jnp.asarray(w0())}

        def loss_fn(p, batch):
            x, y = batch
            return jnp.mean((x @ p["w"] - y) ** 2)
        opt = optax.adam(1e-2) if kind == "adam" else optax.sgd(0.1)
        batch_of = quad_batch
    mstate = None
    if kind == "state":
        mstate = {"mu": jnp.zeros((4,), jnp.float32)}

        def loss_fn(p, ms, batch):
            x, y = batch
            mu = 0.9 * ms["mu"] + 0.1 * x.mean(0)
            return jnp.mean(((x - ms["mu"]) @ p["w"] - y) ** 2), {"mu": mu}
    tr = JTrainer(loss_fn, lambda n: kfopt.synchronous_sgd(opt), params,
                  init_size=schedule[0][0], init_model_state=mstate)
    losses = []
    for size, steps in schedule:
        tr.resize(size)
        for _ in range(steps):
            losses.append(tr.step(tuple(jnp.asarray(a) for a in batch_of(
                tr.step_count, tr.n))))
    final = np.concatenate([np.asarray(t).reshape(-1) for t in
                            jax.tree_util.tree_leaves(tr.current_params())])
    if kind == "state":
        final = np.concatenate([final, np.asarray(
            tr.current_model_state()["mu"])])
    return np.asarray(losses), final, tr.trained_samples


def _assert_matches(ranks, name, want_losses, want_final, tol):
    np.testing.assert_allclose(ranks[0][f"{name}/loss"], want_losses, **tol)
    np.testing.assert_allclose(ranks[0][f"{name}/final"], want_final,
                               **({"rtol": 0, "atol": 2e-5}
                                  if name == "gpt" else tol))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_trajectory_across_grow_and_shrink_matches_jax(ranks, kind):
    losses, final, samples = jax_run(kind)
    _assert_matches(ranks, kind, losses, final, TOL)
    # the newcomers' steps are the job's steps, with the same mean loss
    for r in (2, 3):
        steps = ranks[r][f"{kind}/step"]
        assert steps[0] == 3
        np.testing.assert_array_equal(ranks[r][f"{kind}/loss"],
                                      ranks[0][f"{kind}/loss"][steps])
    # survivors bitwise equal; rank 3 left at the shrink
    for r in (1, 2):
        np.testing.assert_array_equal(ranks[r][f"{kind}/final"],
                                      ranks[0][f"{kind}/final"])
        assert int(ranks[r][f"{kind}/samples"]) == samples == 8 * (
            2 * 3 + 4 * 3 + 3 * 3)
    assert f"{kind}/final" not in ranks[3]
    assert len(ranks[3][f"{kind}/loss"]) == 3
    # rank 0 sent w and, at the grow, Adam's two moments and step
    sent = ranks[0][f"{kind}/sync_bytes"]
    assert sent[1] == 16 + (16 + 16 + 4 if kind == "adam" else 0)
    assert sent[2] == 0                       # a shrink sends nothing


def test_model_state_rides_the_resizes_as_in_jax(ranks):
    """A running mean as model state (BatchNorm's statistics): rank 0's
    is sent with the parameters, and the steps average it as JAX's do;
    every rank starts from its own."""
    losses, final, _ = jax_run("state")
    np.testing.assert_allclose(ranks[0]["state/loss"], losses, **TOL)
    for r in (0, 1, 2):
        got = np.concatenate([ranks[r]["state/final"], ranks[r]["state/mu"]])
        np.testing.assert_allclose(got, final, **TOL)
    np.testing.assert_array_equal(ranks[2]["state/mu"], ranks[0]["state/mu"])


def test_newcomer_without_rank0_state_fails_the_comparison(ranks):
    losses, final, _ = jax_run("adam")
    with pytest.raises(AssertionError):
        _assert_matches(ranks, "adam_fault", losses, final, TOL)
    gap = np.abs(ranks[0]["adam_fault/loss"] - losses).max()
    assert gap > 1e3 * TOL["atol"], gap
    # and the replicas part
    assert not np.array_equal(ranks[2]["adam_fault/final"],
                              ranks[0]["adam_fault/final"])


def test_gpt_grows_from_two_to_three_ranks_as_jax(ranks):
    losses, final, _ = jax_run("gpt", GPT_SCHEDULE)
    _assert_matches(ranks, "gpt", losses, final,
                    {"rtol": 1e-5, "atol": 1e-5})
    for r in (1, 2):
        np.testing.assert_array_equal(ranks[r]["gpt/final"],
                                      ranks[0]["gpt/final"])
    np.testing.assert_array_equal(ranks[2]["gpt/loss"],
                                  ranks[0]["gpt/loss"][2:])


def test_checkpoint_resumes_at_another_size(ranks):
    assert bool(ranks[0]["ck/saved"]) and not bool(ranks[1]["ck/saved"])
    for r in (0, 1):
        assert int(ranks[r]["ck/step"]) == 3
        assert int(ranks[r]["ck/step_count"]) == 3
        assert int(ranks[r]["ck/samples2"]) == int(ranks[0]["ck/samples4"])
        np.testing.assert_array_equal(ranks[r]["ck/w2"], ranks[0]["ck/w4"])
        assert np.abs(ranks[r]["ck/exp_avg"]).max() > 0
        assert np.isfinite(ranks[r]["ck/loss_next"])


def test_sync_progress_exact_past_2_40(ranks):
    for r in (0, 1):
        assert int(ranks[r]["progress"]) == (1 << 40) + 3


# ------------------------------------------------ the wire, both ways
def _cluster(mod_cluster, mod_hosts, n):
    return mod_cluster.from_hostlist(mod_hosts.parse("127.0.0.1:4,h2:2"), n)


def test_cluster_json_is_byte_equal():
    for n in (0, 1, 3, 6):
        c, j = _cluster(Cluster, HostList, n), _cluster(JCluster, JHostList,
                                                        n)
        assert c.to_json() == j.to_json()
        assert c.digest() == j.digest()
        assert Cluster.from_json(j.to_json()).to_json() == j.to_json()
        for m in (0, 2, 5, 7):
            assert c.resize(m).to_json() == j.resize(m).to_json()


def _request(url, method, body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wire_script(server):
    """The same requests against ``server``: (status, body without the
    epoch) of each, plus whether every body carried the server's epoch."""
    url = server.url
    c = _cluster(JCluster, JHostList, 2).to_json().encode()
    c3 = _cluster(JCluster, JHostList, 3).to_json().encode()
    steps = [("GET", None, {}), ("PUT", c, {}), ("GET", None, {}),
             ("PUT", b'{"bad": 1}', {}), ("PUT", b"not json", {}),
             ("PUT", c3, {"If-Match": "0"}), ("PUT", c3, {"If-Match": "1"}),
             ("PUT", c, {"If-Match": "x"}), ("DELETE", None, {}),
             ("GET", None, {}), ("PUT", c, {"If-Match": "2"})]
    out, epochs = [], set()
    for method, body, headers in steps:
        code, d = _request(url, method, body, headers)
        if "epoch" in d:
            epochs.add(d.pop("epoch"))
        if code == 400:
            d = {"error": "..."}       # the parser's message
        out.append((code, d))
    return out, epochs


def test_config_server_wire_matches_jax():
    ours, theirs = ConfigServer().start(), JServer().start()
    try:
        got, got_epochs = _wire_script(ours)
        want, want_epochs = _wire_script(theirs)
    finally:
        ours.stop()
        theirs.stop()
    assert got == want
    assert [c for c, _ in got] == [404, 200, 200, 400, 400, 409, 200, 400,
                                   200, 404, 409]
    assert got_epochs == {ours.epoch} and want_epochs == {theirs.epoch}


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_clients_talk_to_either_server(server_side):
    """The port's client against JAX's server, and JAX's client against
    the port's: 404 before a PUT, a PUT, CAS 409, 400, DELETE."""
    srv = (ConfigServer if server_side == "port" else JServer)().start()
    fetch, put = ((jfetch, jput) if server_side == "port"
                  else (fetch_config, put_config))
    mk = JCluster if server_side == "port" else Cluster
    hosts = JHostList if server_side == "port" else HostList
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            fetch(srv.url)
        assert e.value.code == 404
        c = mk.from_hostlist(hosts.parse("127.0.0.1:4"), 2)
        assert put(srv.url, c) == 1
        v, got = fetch(srv.url)
        assert v == 1 and got.to_json() == c.to_json()
        assert put(srv.url, c.resize(3), if_version=1) == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            put(srv.url, c.resize(4), if_version=1)
        assert e.value.code == 409
        assert fetch(srv.url)[1].size() == 3
        bad = mk(c.runners, c.workers.__class__(list(c.workers) * 2))
        with pytest.raises(urllib.error.HTTPError) as e:
            put(srv.url, bad)
        assert e.value.code == 400
        urllib.request.urlopen(urllib.request.Request(srv.url,
                                                      method="DELETE"))
        with pytest.raises(urllib.error.HTTPError) as e:
            fetch(srv.url)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            put(srv.url, c, if_version=2)     # the DELETE bumped to 3
        assert e.value.code == 409
    finally:
        srv.stop()


def test_fetch_retries_an_unseeded_server_until_the_deadline():
    srv = ConfigServer().start()
    try:
        with pytest.raises(urllib.error.HTTPError):
            fetch_config(srv.url, deadline=0.3, retry_unseeded=True)
        import threading
        c = Cluster.from_hostlist(HostList.parse("127.0.0.1:4"), 2)
        threading.Timer(0.2, srv.put_cluster, (c,)).start()
        assert fetch_config(srv.url, deadline=5.0,
                            retry_unseeded=True)[0] == 1
    finally:
        srv.stop()


def test_coordinator_address_matches_jax():
    peers = ["10.0.0.1:31100", "10.0.0.2:31100"]
    for v in range(0, 40001):
        assert TD.coordinator_address(peers, v) == \
            JD.coordinator_address(peers, v), v
    # distinct for 20000 consecutive versions, then the wrap
    addrs = {TD.coordinator_address(peers, v) for v in range(20000)}
    assert len(addrs) == 20000
    assert TD.coordinator_address(peers, 20000) == \
        TD.coordinator_address(peers, 0)


# --------------------------------- schedule, data shard and policies
def test_step_schedule_matches_jax():
    for spec in ("4:10,8:10,2:5", "2:3,4:3,3:3", "2:2,0:1", "1:1"):
        s, j = StepSchedule.parse(spec), JSchedule.parse(spec)
        assert s.total_steps() == j.total_steps()
        assert [s.size_at(i) for i in range(30)] == \
            [j.size_at(i) for i in range(30)]
        assert s.changes() == j.changes()
        assert s.to_string() == j.to_string()


@pytest.mark.parametrize("shuffle", [False, True])
def test_elastic_data_shard_matches_jax(shuffle):
    s, j = ElasticDataShard(100, 3, shuffle), JShard(100, 3, shuffle)
    progress = 0
    for size, bs in [(4, 20), (8, 40), (2, 20), (4, 20), (3, 64), (5, 33)]:
        a, b = s.batch_indices(progress, bs), j.batch_indices(progress, bs)
        np.testing.assert_array_equal(a, b)
        for r in range(size):
            np.testing.assert_array_equal(s.local_slice(a, r, size),
                                          j.local_slice(b, r, size))
        progress += bs


class _StubTrainer:
    """What the policies see of a trainer, recording the sizes stepped."""

    def __init__(self, n, max_size=8, optimizer=None):
        self.n, self.max_size, self.optimizer = n, max_size, optimizer
        self.step_count = self.trained_samples = 0
        self.sizes = []

    def resize(self, n):
        self.n = n

    def step(self, batch):
        self.sizes.append(self.n)
        self.step_count += 1
        self.trained_samples += 4
        return 0.0


def _jax_sizes(spec, n, steps):
    tr = JTrainer(lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2),
                  lambda k: kfopt.synchronous_sgd(optax.sgd(0.1)),
                  {"w": jnp.zeros((4, 1))}, init_size=n)
    sizes, orig = [], tr.step

    def spy(batch):
        sizes.append(tr.n)
        return orig(batch)
    tr.step = spy

    def batch_fn(t):
        return (jnp.ones((t.n * 2, 4)), jnp.ones((t.n * 2, 1)))
    losses = JRunner([JSched(JSchedule.parse(spec))], tr, epoch_size=64,
                     epochs=1).run(batch_fn, steps_per_epoch=steps)
    return sizes, len(losses)


@pytest.mark.parametrize("spec,n,steps", [("4:3,8:3,2:3", 4, 9),
                                          ("2:2,0:1", 2, 10)])
def test_scheduled_resize_policy_matches_jax(spec, n, steps):
    tr = _StubTrainer(n)
    losses = PolicyRunner([ScheduledResizePolicy(StepSchedule.parse(spec))],
                          tr, epoch_size=64, epochs=1).run(
        lambda t: None, steps_per_epoch=steps)
    want_sizes, want_len = _jax_sizes(spec, n, steps)
    assert tr.sizes == want_sizes and len(losses) == want_len


def test_gns_policy_matches_jax():
    """The same noise-scale readings drive the same proposals: the JAX
    policy reads ``noise_scale`` from the optax state, the port's from the
    optimizer (``opt.noise_scale``)."""
    readings = [0.0, 40.0, 40.0, 200.0, 210.0, float("nan"), 15.0, 15.0,
                900.0, 900.0, 60.0, 60.0]
    kw = dict(per_lane_batch=8, min_size=1, max_size=8, check_every=2,
              warmup_steps=2, cooldown_steps=3, deadband=1.5)

    class Opt:
        noise_scale = None

    class JState:
        noise_scale = None

    ours, theirs = GNSScalingPolicy(**kw), JGNS(**kw)
    opt, jst = Opt(), JState()
    tr = _StubTrainer(2, optimizer=opt)
    jtr = _StubTrainer(2)
    jtr.opt_state = jst
    from kungfu_tpu.elastic.policy import PolicyContext as JCtx
    from kungfu_tpu_torch.elastic import PolicyContext
    ctx, jctx = PolicyContext(tr), JCtx(jtr)
    for step, gns in enumerate(readings):
        opt.noise_scale = torch.tensor(gns)
        jst.noise_scale = np.full((2,), gns, np.float32)
        ctx.step = jctx.step = step
        ours.after_step(ctx)
        theirs.after_step(jctx)
        for c, t in ((ctx, tr), (jctx, jtr)):
            if c._requested_size is not None:
                t.resize(c._requested_size)
                c._requested_size = None
    assert [(s, p) for s, _, p in ours.history] == \
        [(s, p) for s, _, p in theirs.history]
    assert tr.n == jtr.n and any(p for _, _, p in ours.history)


def test_gns_policy_over_the_launcher_driven_trainer_matches_jax(tmp_path):
    """A launcher-driven trainer caps nothing (its cluster is the config
    server's), so the policy's own max_size bounds the proposals past the
    size the rank joined at, as over JAX's DistributedElasticTrainer,
    which has no max_size."""
    from types import SimpleNamespace
    from kungfu_tpu_torch.elastic import DistributedElasticTrainer
    from kungfu_tpu_torch.elastic.policy import PolicyContext
    from kungfu_tpu.elastic.policy import PolicyContext as JCtx
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    we = TE.parse(TE.worker_argv(0, PeerList.parse("127.0.0.1:31100:0"), 0,
                                 None, str(tmp_path)))
    tr = DistributedElasticTrainer(
        lambda p, b: (p["w"] ** 2).sum(),
        lambda leaves, n: synchronous_sgd(torch.optim.SGD(leaves, lr=0.1)),
        {"w": torch.zeros(4, 1)}, env=we, backend="gloo")
    try:
        assert tr.max_size is None and tr.n == 1
        kw = dict(per_lane_batch=8, min_size=1, max_size=6, check_every=1,
                  warmup_steps=0, cooldown_steps=2, deadband=1.5)
        ours, theirs = GNSScalingPolicy(**kw), JGNS(**kw)
        jst = SimpleNamespace(noise_scale=None)
        ctx = PolicyContext(tr)
        jctx = JCtx(SimpleNamespace(n=1, opt_state=jst))
        for step, gns in enumerate([64.0, 64.0, 64.0, 24.0, 8.0, 200.0]):
            tr.optimizer.noise_scale = torch.tensor(gns)
            jst.noise_scale = np.full((2,), gns, np.float32)
            ctx.step = jctx.step = step
            ours.after_step(ctx)
            theirs.after_step(jctx)
        assert [(s, p) for s, _, p in ours.history] == \
            [(s, p) for s, _, p in theirs.history]
        assert ours.history[0][2] == 6
    finally:
        tr.shutdown()


# ------------------------------------------------- npz and checkpoints
def test_npz_round_trips_across_packages(tmp_path):
    tree = {"layer": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "scales": [np.float32(1.5), np.float32(2.5)],
            "layers": [{"b": np.ones(2, np.float32)}] * 2}
    ttree = {"layer": {"w": torch.from_numpy(tree["layer"]["w"])},
             "scales": [torch.tensor(1.5), torch.tensor(2.5)],
             "layers": [{"b": torch.ones(2)}] * 2}
    TCK.save_npz(str(tmp_path / "port.npz"), ttree)
    JCK.save_npz(str(tmp_path / "jax.npz"), tree)
    a, b = (JCK.load_npz(str(tmp_path / f)) for f in ("port.npz",
                                                     "jax.npz"))
    assert sorted(a) == sorted(b) == sorted(TCK.load_npz(str(
        tmp_path / "jax.npz")))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    back = TCK.restore_npz_like(ttree, str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(back["layer"]["w"].numpy(),
                                  tree["layer"]["w"])
    jback = JCK.restore_npz_like(tree, str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(jback["scales"][1]), 2.5)


def test_checkpointer_window_and_restore(tmp_path):
    state = {"w": torch.arange(4.0), "opt": {"step": 3, "lr": 0.1},
             "pair": (torch.ones(2, dtype=torch.bfloat16), 7)}
    with TCK.Checkpointer(str(tmp_path), max_to_keep=2) as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore()
        for s in (1, 2, 3):
            state["w"] += 1
            assert ck.save(s, state, meta={"step": s})
        ck.wait()
        assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
        assert not ck.save(3, state)            # exists, not forced
        step, got, meta = ck.restore()
    assert step == 3 and meta == {"step": 3}
    torch.testing.assert_close(got["w"], torch.arange(4.0) + 3)
    assert got["opt"] == {"step": 3, "lr": 0.1}
    assert got["pair"][0].dtype == torch.bfloat16 and got["pair"][1] == 7
    like = {"w": torch.zeros(4, dtype=torch.float64), "opt": {"step": 0,
            "lr": 0.0}, "pair": (torch.zeros(2), 0)}
    _, conv, _ = TCK.Checkpointer(str(tmp_path)).restore(like, step=2)
    assert conv["w"].dtype == torch.float64 and conv["pair"][0].dtype == \
        torch.float32
    with pytest.raises(ValueError):
        TCK.Checkpointer(str(tmp_path)).restore({**like, "w": torch.zeros(
            5)})


# -------------------------------------------------------- top-level API
@pytest.fixture
def installed():
    before = TE.installed()
    yield
    TE.install(before)


def test_toplevel_api_singleton(installed):
    TE.install(TE.SINGLETON)
    assert kft.uid() == f"localhost:{os.getpid()}:0"
    assert kft.current_rank() == 0 and kft.current_cluster_size() == 1
    assert kft.current_local_rank() == 0 and kft.current_local_size() == 1
    kft.run_barrier()
    assert kft.detached() is False
    with pytest.raises(RuntimeError):
        kft.propose_new_size(2)


def test_toplevel_api_worker(installed):
    peers = PeerList.parse("10.0.0.1:9100:0,10.0.0.1:9101:1,10.0.0.2:9100:0")
    we = kft.init(["prog", "--x", "1", *TE.worker_argv(
        1, peers, 7, "http://h/config", "/tmp/r")])
    assert TE.installed() is we and we.rendezvous == "/tmp/r"
    assert kft.uid() == "10.0.0.1:9101:7"
    assert kft.current_rank() == 1 and kft.current_cluster_size() == 3
    assert kft.current_local_rank() == 1 and kft.current_local_size() == 2
    assert TE.parse(TE.worker_argv(2, peers, 0)).rank() == 2


def test_propose_new_size_roundtrip_and_cas(installed):
    hl = HostList.parse("127.0.0.1:4")
    cluster = Cluster(runners=hl.gen_runner_list(30100),
                      workers=hl.gen_peer_list(2, 10000))
    srv = ConfigServer().start()
    try:
        srv.put_cluster(cluster)
        kft.init(TE.worker_argv(0, cluster.workers, 1, srv.url))
        assert kft.propose_new_size(3)
        assert srv.get_cluster()[1].size() == 3
        # a CAS on a stale version loses and leaves the winner's cluster
        v, got = fetch_config(srv.url)
        put_config(srv.url, got.resize(4))
        with pytest.raises(urllib.error.HTTPError) as e:
            put_config(srv.url, got.resize(1), if_version=v)
        assert e.value.code == 409 and srv.get_cluster()[1].size() == 4
    finally:
        srv.stop()
    assert kft.propose_new_size(2) is False     # unreachable


def test_flash_layout_ignores_the_stride_of_a_size_one_dimension():
    """A microbatch of one sequence (the elastic phase's) may carry any
    stride on its batch dimension, which no kernel reads."""
    from kungfu_tpu_torch.ops.flash_attention import _kernel_layout_ok
    one, two = (torch.empty(b, 64, 4, 64, dtype=torch.bfloat16)
                for b in (1, 2))
    assert _kernel_layout_ok(one.as_strided(one.shape, (1, 256, 64, 1)))
    assert not _kernel_layout_ok(two.as_strided(two.shape, (1, 256, 64, 1)))
    assert not _kernel_layout_ok(one.as_strided(one.shape, (256, 4, 64, 1)))


# ------------------------------------------------------------- watcher
FAKE_WORKER = textwrap.dedent("""
    import os, sys, time
    d, name = sys.argv[1], sys.argv[2]
    open(os.path.join(d, "spawned_" + name), "w").close()
    t_end = time.monotonic() + 60
    while not os.path.exists(os.path.join(d, "release_" + name)):
        if time.monotonic() > t_end:
            sys.exit(3)
        time.sleep(0.01)
""")


@pytest.mark.parametrize("follow", ["server", "url"])
def test_watcher_restarts_a_worker_dropped_and_added_back(tmp_path, follow):
    """A shrink then a grow that adds the dropped worker back while its
    old process is still leaving: the watcher starts the worker anew, at
    the grow's version, once the old process has exited 0.  Subscribed to
    the server it sees both versions however close they come; polling, it
    sees them when each lives for several polls."""
    import threading
    import time
    from kungfu_tpu_torch.launcher.watch import watch_run
    logs = tmp_path / "logs"
    logs.mkdir()
    srv = ConfigServer().start()
    c3 = Cluster.from_hostlist(HostList.parse("127.0.0.1:3"), 3)
    srv.put_cluster(c3)

    def argv_for(rank, cluster, version):
        name = f"{cluster.workers[rank].port}_v{version}"
        return [sys.executable, "-c", FAKE_WORKER, str(tmp_path), name]

    def wait_for(name):
        t_end = time.monotonic() + 30
        while not (tmp_path / f"spawned_{name}").exists():
            assert time.monotonic() < t_end, f"{name} never started"
            time.sleep(0.01)

    def release(name):
        (tmp_path / f"release_{name}").touch()

    got = {}

    def watch():
        try:
            got["exits"] = watch_run(srv if follow == "server" else srv.url,
                                     argv_for, str(logs), poll_interval=0.05,
                                     timeout=60)
        except Exception as e:          # reported by the main thread
            got["error"] = e
    th = threading.Thread(target=watch)
    th.start()
    try:
        ports = [p.port for p in c3.workers]
        for port in ports:
            wait_for(f"{port}_v1")
        srv.put_cluster(c3.resize(2))            # v2 drops the last worker
        if follow == "url":
            time.sleep(1.0)
        srv.put_cluster(c3.resize(3))            # v3 adds it back
        if follow == "url":
            time.sleep(1.0)
        assert not (tmp_path / f"spawned_{ports[2]}_v3").exists()
        release(f"{ports[2]}_v1")                # the old process leaves
        wait_for(f"{ports[2]}_v3")
        for name in [f"{p}_v1" for p in ports[:2]] + [f"{ports[2]}_v3"]:
            release(name)
        th.join(60)
    finally:
        for port in ports:
            for v in (1, 3):
                release(f"{port}_v{v}")
        th.join(60)
        srv.stop()
    assert "error" not in got, got.get("error")
    assert got["exits"] == {f"127.0.0.1_{p}_v1": 0 for p in ports} | {
        f"127.0.0.1_{ports[2]}_v3": 0}


# ------------------------------------------------------------- example
def test_elastic_resize_example_on_cpu(tmp_path):
    """The first job shrinks 3 -> 2 and grows back to 3 a step later (the
    watcher restarts the rank that left), checkpoints, and a second job
    of 3 ranks resumes it."""
    out = tmp_path / "records.json"
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.examples.elastic_resize",
         "--device", "cpu", "--schedule", "3:1,2:1,3:1,3:3", "--batch", "12",
         "--json", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    recs = json.loads(out.read_text())
    assert [(x["job"], x["step"], x["ranks"], x["samples"]) for x in recs] \
        == [("first", 0, 3, 12), ("first", 1, 2, 24), ("first", 2, 3, 36),
            ("second", 3, 3, 48), ("second", 4, 3, 60), ("second", 5, 3, 72)]
    assert all(np.isfinite(x["loss"]) for x in recs)
    assert "resumed step 3 at ranks=3" in r.stdout
    assert "job first: 4 worker processes, exit codes [0, 0, 0, 0]" \
        in r.stdout
    assert "job second: 3 worker processes, exit codes [0, 0, 0]" in r.stdout


def test_elastic_resize_example_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.examples.elastic_resize"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode != 0 and "no CUDA device" in r.stderr
