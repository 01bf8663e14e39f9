"""Sharded elasticity in the port against the JAX package, on the CPU.

Every job runs gloo ranks of the port's ``ShardedElasticTrainer``
(processes spawned by the port's watcher under its ``ConfigServer``,
meeting through versioned FileStores; no TCP port), ZeRO-3 over a flat
vector with Adam, its moments sharded too.  The jobs port
tests/test_elastic_sharded.py (the JAX phases are processes x devices;
the port's are ranks):

- ``preempt`` (:136): 2 ranks, rank 1 terminated after step 6; the
  survivor re-shards from its block and the ring replica, trains at 1,
  and a new rank 1 pulls its half at 2;
- ``cadence`` (:233): a commit every 3 steps, rank 1 terminated after
  step 7; the survivor rewinds to the commit of step 6 and redoes step 7;
- ``handoff`` (:392): 3 ranks shrink to 1 in one step (rank 1's block
  and its replica both leave; only the hand-off saves it), then grow to
  2;
- ``gpt``: a 2-layer GPT, 3 ranks, rank 2 killed inside its gradient
  reduce-scatter; the survivors re-shard and redo the step at 2;
- ``double``: 3 ranks, rank 1 killed and rank 2 stopped with it, then
  killed 2 s later (adjacent), so the watcher excludes them at two
  versions: the survivor gives up the first (rank 2 never comes to its
  rendezvous) for the second, where rank 1's block is on no survivor,
  and raises;
- ``commit``: 3 ranks, rank 2 killed inside the ring exchange of a
  commit that one survivor records and the other does not: the previous
  commit is the recovery point;
- ``first``: 3 ranks, rank 2 killed in the first step, before Adam has
  moments: the survivors re-shard the constructor's commit (the
  parameters alone) and build the optimizer afresh.

The oracle replays each job's effective (size, step) sequence on JAX's
``kungfu_tpu.parallel.make_fsdp_step`` over a mesh of each segment's
size, carrying the flat parameters and Adam's moments between segments
(unpadded, re-padded with JAX's ``_layout``).  At every re-shard each
rank records the chunks it built and two planted faults computed from
the same received blocks (the replica zeroed; the new layout's block
length where the old one belongs): the sound chunks must equal JAX's
state at the commit M that was re-sharded, and each fault must not.
Limits are tests/test_torch_fsdp.py's for Adam: losses rtol 1e-4,
parameters rtol 2e-4 and atol 2e-5; the final parameters of the linear
jobs also meet the JAX test's numpy oracle (``_oracle_wsum``) at its rtol
1e-4.
"""
import ast
import functools
import itertools
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh

from kungfu_tpu.elastic.sharded import ShardedElasticTrainer as JSharded
from kungfu_tpu.elastic.sharded import _layout as jlayout
from kungfu_tpu.models import gpt as JG
from kungfu_tpu.ops.chunked_ce import chunked_cross_entropy as jce
from kungfu_tpu.parallel import make_fsdp_step
from kungfu_tpu_torch.elastic import ConfigServer, sharded as SH
from kungfu_tpu_torch.launcher import env as TE
from kungfu_tpu_torch.launcher.watch import WorkerFailed, watch_run
from kungfu_tpu_torch.plan import Cluster, HostList, PeerList

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
TOL = {"rtol": 2e-4, "atol": 2e-5}
GPT = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq=16, mlp="swiglu", rope=True)
GPT_LR, GPT_ROWS, CHUNK = 1e-3, 6, 32
QUAD_LR = 0.05
JOBS = {
    "preempt": dict(kind="quad", rows=8, size=2, steps=30, act="term",
                    victims=[1], at=6, regrow=True),
    "cadence": dict(kind="quad", rows=8, size=2, steps=24, act="term",
                    victims=[1], at=7, snapshot_every=3),
    "handoff": dict(kind="quad", rows=12, size=3, steps=30, shrink=True),
    "gpt": dict(kind="gpt", size=3, steps=5, act="kill_rs", victims=[2],
                at=2),
    "double": dict(kind="quad", rows=12, size=3, steps=6, act="kill_rs",
                   victims=[1, 2], at=2, stagger=2.0),
    "commit": dict(kind="quad", rows=12, size=3, steps=6,
                   act="kill_commit", victims=[2], at=3),
    "first": dict(kind="quad", rows=12, size=3, steps=4, act="kill_rs",
                  victims=[2], at=0),
}

WORKER = textwrap.dedent("""
    import json, os, pickle, signal, subprocess, sys, threading, time
    import numpy as np
    import torch
    from kungfu_tpu_torch.convert import params_from_jax
    from kungfu_tpu_torch.elastic import sharded as SH
    from kungfu_tpu_torch.launcher import env as E
    from kungfu_tpu_torch.models import gpt as TG
    from kungfu_tpu_torch.ops.chunked_ce import chunked_cross_entropy
    from kungfu_tpu_torch.parallel import fsdp as FS
    from kungfu_tpu_torch.utils.tree import tree_leaves

    torch.set_num_threads(1)
    job = json.load(open(sys.argv[1]))
    out = job["out"]
    we = E.install(E.parse(sys.argv[2:]))
    rank0 = we.rank()
    stream = f"{we.self_spec.port}_v{we.cluster_version}"
    victim = rank0 in job["victims"] and we.cluster_version == 1
    with open(f"{out}/pid.{rank0}", "w") as f:
        f.write(str(os.getpid()))

    if job["kind"] == "gpt":
        cfg = TG.GPTConfig(dtype=torch.float32, **job["gpt"])
        with open(job["gpt_weights"], "rb") as f:
            params = params_from_jax(pickle.load(f), cfg)

        def loss_fn(p, batch):
            feats = TG.forward_features(p, batch[0], cfg, attn="dense")
            return chunked_cross_entropy(feats, p["lm_head"], batch[1],
                                         job["chunk"]).mean()

        def batch_of(i):
            toks = np.random.RandomState(100 + i).randint(
                0, cfg.vocab_size, (job["rows"], cfg.max_seq))
            toks = torch.from_numpy(toks.astype(np.int32))
            return toks, torch.roll(toks, -1, dims=1)
        lr = job["gpt_lr"]
    else:
        rng = np.random.RandomState(0)
        X = rng.randn(job["rows"], 16).astype(np.float32)
        Y = X @ rng.randn(16, 4).astype(np.float32)
        params = {"w": torch.zeros(16, 4), "b": torch.zeros(4)}

        def loss_fn(p, batch):
            bx, by = batch
            return ((bx @ p["w"] + p["b"] - by) ** 2).mean()

        def batch_of(i):
            return torch.from_numpy(X), torch.from_numpy(Y)
        lr = job["quad_lr"]

    events = [0]
    real_build = SH.ShardedElasticTrainer._build

    def build(self):
        # the chunks this re-shard builds, and the two planted faults
        # computed from the same received blocks
        sy = self._synced
        if sy["M"] is not None:
            _, chunk, _ = SH._layout(self._vec_size, self.n, self.n)
            own = self._slots[sy["M"]]["rank"] if sy["M"] in self._slots \\
                else None
            arrs = {}
            for k in sy["names"]:
                got, dt = sy["pulled"][k], sy["dtypes"][k]
                args = (sy["lo"], sy["hi"])
                arrs[f"sound/{k}"] = self._assemble(
                    k, *args, sy["old_block"], got, dt).numpy()
                arrs[f"zero_replica/{k}"] = self._assemble(
                    k, *args, sy["old_block"],
                    {r: b if r == own else torch.zeros_like(b)
                     for r, b in got.items()}, dt).numpy()
                arrs[f"wrong_offset/{k}"] = self._assemble(
                    k, *args, chunk, got, dt).numpy()
            np.savez(f"{out}/ev.{stream}.{events[0]}.npz", M=sy["M"],
                     from_n=self.reshards[-1]["from_n"],
                     lo=sy["lo"], hi=sy["hi"], n=self.n, rank=self.rank,
                     version=self.version, **arrs)
            events[0] += 1
        real_build(self)
    SH.ShardedElasticTrainer._build = build

    tr = None
    real_sync = FS.fsdp_grad_sync

    def sync_then_die(gflat, group=None):
        # the victim dies inside its gradient reduce-scatter: it runs on a
        # thread, and the process is killed 10 ms into it.  The first
        # victim stops the others first, so they never recover, and has
        # them killed ``stagger`` s after itself
        if victim and job["act"] == "kill_rs" and tr.step_count == job["at"]:
            threading.Thread(target=real_sync, args=(gflat, group),
                             daemon=True).start()
            time.sleep(0.01)
            for r in job["victims"][1:]:
                pid = int(open(f"{out}/pid.{r}").read())
                os.kill(pid, signal.SIGSTOP)
                subprocess.Popen(["/bin/sh", "-c",
                                  f"sleep {job['stagger']}; kill -9 {pid}"])
            os.kill(os.getpid(), signal.SIGKILL)
        return real_sync(gflat, group)
    FS.fsdp_grad_sync = sync_then_die
    if victim and job["act"] == "kill_rs" and rank0 != job["victims"][0]:
        FS.fsdp_grad_sync = real_sync      # killed by the first victim
    real_exchange = SH._exchange

    def exchange_then_die(sends, recvs):
        # the victim dies inside the ring exchange of the commit of step
        # ``at``: it takes its predecessor's block (that rank's exchange
        # completes and it records the commit) and sends its successor
        # nothing (that rank's fails: it does not)
        if victim and tr is not None and tr.step_count == job["at"]:
            real_exchange([], recvs)
            os.kill(os.getpid(), signal.SIGKILL)
        return real_exchange(sends, recvs)
    if job["act"] == "kill_commit":
        SH._exchange = exchange_then_die

    tr = SH.ShardedElasticTrainer(
        loss_fn, lambda leaves, n: torch.optim.Adam(leaves, lr=lr), params,
        device="cpu", snapshot_every=job["snapshot_every"],
        recover_timeout=30.0, collective_timeout_s=60.0, heartbeat_s=0.0)
    rec = {"rank0": rank0, "stream": stream, "steps": [], "error": None,
           "sizes": [tr.size], "state_bytes": []}
    proposed = set()
    while tr.step_count < job["steps"]:
        i = tr.step_count
        if tr.rank == 0:
            if job.get("shrink"):
                if tr.size == 3 and i >= 4 and 1 not in proposed:
                    tr.propose_new_size(1)
                    proposed.add(1)
                if tr.size == 1 and i >= 8 and 2 not in proposed:
                    tr.propose_new_size(2)
                    proposed.add(2)
            if job.get("regrow") and tr.size == 1 and not victim \\
                    and 2 not in proposed:
                tr.propose_new_size(2)
                proposed.add(2)
        try:
            loss = tr.step(batch_of(i))
        except SH.ShardedStateError as e:
            rec["error"] = {"type": type(e).__name__, "message": str(e)}
            break
        if loss is None:
            rec["detached"] = True
            break
        rec["steps"].append({"batch": i, "step": tr.step_count,
                             "n": tr.size, "loss": loss})
        if tr.size != rec["sizes"][-1]:
            rec["sizes"].append(tr.size)
        _, chunk, _ = SH._layout(tr._vec_size, tr.size, tr.size)
        vecs = len(tr._held[max(tr._held)][tr.rank])
        rec["state_bytes"].append(
            [tr.local_state_bytes(),
             4 * chunk * vecs * (2 if tr.size > 1 else 1)])
        if victim and job["act"] == "term" and tr.step_count == job["at"]:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(30)
    if rec["error"] is None and not rec.get("detached"):
        rec["final_flat"] = torch.cat(
            [t.reshape(-1) for t in tree_leaves(tr.current_params())]
        ).tolist()
        rec["samples"] = tr.trained_samples
        rec["recoveries"] = len(tr.recoveries)
        rec["size"] = tr.size
    with open(f"{out}/rec.{stream}.json", "w") as f:
        json.dump(rec, f)
    if rec["error"] is None and not rec.get("detached"):
        tr.shutdown()
""")


def _jcfg():
    return JG.GPTConfig(dtype=jnp.float32, **GPT)


def _jgpt_params():
    return jax.tree_util.tree_map(
        np.asarray, JG.init_params(jax.random.PRNGKey(0), _jcfg()))


def _run_job(name, tmp):
    spec = {"snapshot_every": 1, "victims": [], "act": None, "rows": GPT_ROWS,
            **JOBS[name]}
    out = tmp / name
    out.mkdir()
    job = dict(spec, out=str(out), gpt=GPT, gpt_lr=GPT_LR, quad_lr=QUAD_LR,
               chunk=CHUNK, gpt_weights=str(tmp / "gpt.pkl"))
    (out / "job.json").write_text(json.dumps(job))
    srv = ConfigServer().start()
    srv.put_cluster(Cluster.from_hostlist(HostList.parse("127.0.0.1:3"),
                                          spec["size"]))
    exclusions, error = [], None

    def argv_for(rank, cluster, version):
        return [sys.executable, "-c", WORKER, str(out / "job.json"),
                *TE.worker_argv(rank, cluster.workers, version, srv.url,
                                str(out / "rdzv"), 0.0)]
    t0 = time.monotonic()
    try:
        exits = watch_run(srv, argv_for, str(out), poll_interval=0.05,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          cwd=str(REPO), timeout=120,
                          exclusions=exclusions)
    except WorkerFailed as e:
        exits, error = None, str(e)
    finally:
        final = srv.get_cluster()[1].size()
        srv.stop()
    recs = [json.loads(f.read_text()) for f in sorted(out.glob("rec.*"))]
    events = []
    for f in sorted(out.glob("ev.*.npz")):
        with np.load(f) as z:
            events.append({k: z[k] for k in z.files})
    return {"exits": exits, "error": error, "recs": recs, "events": events,
            "exclusions": exclusions, "final_size": final,
            "seconds": time.monotonic() - t0}


def _run_example():
    """The example at 3 -> 1 -> 2 ranks, two steps a stage."""
    t0 = time.monotonic()
    got = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.examples.sharded_elastic",
         "--device", "cpu", "--schedule", "3:2,1:2,2:2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120)
    return {"code": got.returncode, "stdout": got.stdout,
            "stderr": got.stderr, "seconds": time.monotonic() - t0}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every job and the example, run once for the module, side by
    side."""
    tmp = tmp_path_factory.mktemp("sharded")
    with open(tmp / "gpt.pkl", "wb") as f:
        pickle.dump(_jgpt_params(), f)
    with ThreadPoolExecutor(len(JOBS) + 1) as pool:
        example = pool.submit(_run_example)
        futures = {n: pool.submit(_run_job, n, tmp) for n in JOBS}
        got = {n: f.result() for n, f in futures.items()}
        got["example"] = example.result()
        return got


def effective(rec):
    """The (size, batch) and loss of every step that stands: a step a
    restore rewound is replaced by the one trained at its count later."""
    by_step = {s["step"]: s for s in rec["steps"]}
    return [by_step[k] for k in sorted(by_step)]


def _quad_data(rows):
    rng = np.random.RandomState(0)
    x = rng.randn(rows, 16).astype(np.float32)
    return x, x @ rng.randn(16, 4).astype(np.float32)


def _gpt_batch(i, rows=GPT_ROWS):
    toks = np.random.RandomState(100 + i).randint(
        0, GPT["vocab_size"], (rows, GPT["max_seq"])).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


@functools.lru_cache(maxsize=None)
def jax_replay(kind, seq, rows=GPT_ROWS):
    """JAX's flat ZeRO-3 step over ``seq`` ((size, batch) pairs), a mesh
    of each segment's size, Adam's state carried between segments:
    every step's loss, and the unpadded (params, mu, nu) after each step
    count (params alone at 0)."""
    if kind == "gpt":
        cfg = _jcfg()
        params = _jgpt_params()

        def loss_fn(p, batch):
            feats = JG.forward_features(p, batch[0], cfg, attn="dense")
            return jce(feats, p["lm_head"], batch[1], CHUNK).mean()
        opt, batch_of = optax.adam(GPT_LR), _gpt_batch
    else:
        params = {"w": np.zeros((16, 4), np.float32),
                  "b": np.zeros((4,), np.float32)}
        data = _quad_data(rows)

        def loss_fn(p, batch):
            return jnp.mean((batch[0] @ p["w"] + p["b"] - batch[1]) ** 2)
        opt, batch_of = optax.adam(QUAD_LR), lambda i: data
    p = np.asarray(ravel_pytree(params)[0])
    size = p.shape[0]
    mu = nu = np.zeros(size, np.float32)
    count = 0
    states, losses = {0: (p, None, None)}, []
    for n, group in itertools.groupby(seq, key=lambda s: s[0]):
        mesh = Mesh(np.array(jax.devices()[:n]), ("fsdp",))
        init, make_step = make_fsdp_step(loss_fn, opt, mesh)
        flat, ost, meta = init(params)
        padded = jlayout(size, n, n)[0]

        def pad(v):
            out = np.zeros(padded, np.float32)
            out[:size] = v
            return out
        flat = jax.device_put(pad(p), flat.sharding)
        leaves, tdef = jax.tree_util.tree_flatten(ost)
        ost = jax.tree_util.tree_unflatten(tdef, [
            jax.device_put(np.asarray(count, leaves[0].dtype),
                           leaves[0].sharding),
            jax.device_put(pad(mu), leaves[1].sharding),
            jax.device_put(pad(nu), leaves[2].sharding)])
        step = make_step(meta)
        for _, b in group:
            flat, ost, loss = step(flat, ost, tuple(
                jnp.asarray(a) for a in batch_of(b)))
            losses.append(float(loss))
            count, mu, nu = [np.asarray(x)
                             for x in jax.tree_util.tree_leaves(ost)]
            p, mu, nu = np.asarray(flat)[:size], mu[:size], nu[:size]
            states[len(losses)] = (p, mu, nu)
    return np.asarray(losses), states


def _oracle_wsum():
    """tests/test_elastic_sharded.py's numpy oracle, taken from its source
    (importing that module would probe the JAX data plane)."""
    tree = ast.parse((REPO / "tests" / "test_elastic_sharded.py").read_text())
    fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef)
              and f.name == "_oracle_wsum")
    ns = {"np": np}
    exec(compile(ast.Module([fn], []), "test_elastic_sharded.py", "exec"), ns)
    return ns["_oracle_wsum"]


def _survivors(job):
    return [r for r in job["recs"] if r.get("final_flat") is not None]


def _check_trajectory(job, name):
    """Losses and final parameters against the JAX replay; every rank's
    final parameters bit for bit equal; ``local_state_bytes`` the own
    block and the predecessor's."""
    spec = JOBS[name]
    assert job["error"] is None, job["error"]
    alive = _survivors(job)
    first = max(alive, key=lambda r: len(r["steps"]))
    eff = effective(first)
    seq = tuple((s["n"], s["batch"]) for s in eff)
    losses, states = jax_replay(spec["kind"], seq, spec.get("rows",
                                                            GPT_ROWS))
    np.testing.assert_allclose([s["loss"] for s in eff], losses,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(first["final_flat"], states[len(seq)][0],
                               **TOL)
    for r in alive:
        assert r["final_flat"] == first["final_flat"]
        assert r["samples"] == first["samples"] == len(seq) * spec.get(
            "rows", GPT_ROWS)
        for got, want in r["state_bytes"]:
            assert got == want
    if spec["kind"] == "quad":
        wsum = float(np.square(np.asarray(first["final_flat"],
                                          np.float64)).sum())
        want = _oracle_wsum()(spec["rows"], first["samples"] // spec["rows"])
        assert np.isclose(wsum, want, rtol=1e-4), (wsum, want)
    return seq, alive


def _events(job):
    """version -> the re-shard's records, one a new rank."""
    by = {}
    for ev in job["events"]:
        by.setdefault(int(ev["version"]), []).append(ev)
    return {v: sorted(evs, key=lambda e: int(e["rank"]))
            for v, evs in sorted(by.items())}


def _check_reshards(job, name, seq):
    """Each re-shard's chunks, joined over the new ranks, against JAX's
    state at M, and how far each planted fault misses it (the largest
    difference over the vectors).  Returns the events' (old size, new
    size, M) and the misses, one an event."""
    spec = JOBS[name]
    _, states = jax_replay(spec["kind"], seq, spec.get("rows", GPT_ROWS))
    out, misses = [], {"zero_replica": [], "wrong_offset": []}
    for version, evs in _events(job).items():
        n = int(evs[0]["n"])
        assert [int(e["rank"]) for e in evs] == list(range(n)), version
        M = int(evs[0]["M"])
        assert {int(e["M"]) for e in evs} == {M}
        want = dict(zip(("p", "exp_avg", "exp_avg_sq"), states[M]))
        names = [k.split("/")[1] for k in evs[0] if k.startswith("sound/")]
        assert names == (["p"] if M == 0 else
                         ["exp_avg", "exp_avg_sq", "p"]), names
        miss = dict.fromkeys(misses, 0.0)
        for k in names:
            joined = {f: np.concatenate([e[f"{f}/{k}"] for e in evs])
                      for f in ("sound", "zero_replica", "wrong_offset")}
            np.testing.assert_allclose(joined["sound"], want[k], **TOL,
                                       err_msg=f"v{version} {k}")
            for f in misses:
                miss[f] = max(miss[f], float(np.max(np.abs(
                    joined[f] - want[k]))))
        for f in misses:
            misses[f].append(miss[f])
        out.append((int(evs[0]["from_n"]), n, M))
    return out, misses


def test_preempted_reshard_2_1_2(jobs):
    """tests/test_elastic_sharded.py:136: the survivor re-shards from its
    block and the replica, trains at 1, and a new rank pulls its half."""
    job = jobs["preempt"]
    seq, alive = _check_trajectory(job, "preempt")
    assert len(job["exclusions"]) == 1 and job["final_size"] == 2
    assert sorted(r["rank0"] for r in alive) == [0, 1]
    survivor = next(r for r in alive if r["stream"].endswith("_v1"))
    assert survivor["sizes"] == [2, 1, 2] and survivor["recoveries"] == 1
    assert [n for n, _ in itertools.groupby(n for n, _ in seq)] == [2, 1, 2]
    assert seq[:6] == tuple((2, b) for b in range(6))
    events, _ = _check_reshards(job, "preempt", seq)
    # the fresh start records none; the kill re-shards the commit of
    # step 6, the grow the commit the survivor made at its fence
    assert events[0] == (2, 1, 6) and events[1][:2] == (1, 2)


def test_commit_cadence_rewinds_to_the_last_commit(jobs):
    """:233: snapshot_every=3, rank 1 terminated after step 7: the
    survivor restores the commit of step 6 and redoes step 7 at 1."""
    job = jobs["cadence"]
    seq, alive = _check_trajectory(job, "cadence")
    assert len(alive) == 1 and alive[0]["recoveries"] == 1
    steps = [(s["step"], s["n"]) for s in alive[0]["steps"]]
    assert steps[:8] == [(k, 2) for k in range(1, 8)] + [(7, 1)]
    assert seq[6] == (1, 7) and seq[5] == (2, 5)
    events, _ = _check_reshards(job, "cadence", seq)
    assert events == [(2, 1, 6)]


def test_voluntary_shrink_handoff_3_1_2(jobs):
    """:392: 3 ranks shrink to 1 in one step (rank 1's block and its
    replica on rank 2 both leave: only the hand-off keeps it), then grow
    to 2; both finish equal, on JAX's trajectory."""
    job = jobs["handoff"]
    seq, alive = _check_trajectory(job, "handoff")
    assert job["exclusions"] == [] and job["final_size"] == 2
    first = next(r for r in alive if r["stream"].endswith("_v1"))
    assert first["sizes"] == [3, 1, 2]
    events, _ = _check_reshards(job, "handoff", seq)
    assert [e[:2] for e in events] == [(3, 1), (1, 2)]


def test_gpt_recovers_from_a_kill_as_jax(jobs):
    """A 2-layer GPT (d_model 64, dense attention, chunked CE) at 3
    ranks; rank 2 dies in step 3's reduce-scatter, the survivors re-shard
    the commit of step 2 and redo the step at 2."""
    job = jobs["gpt"]
    seq, alive = _check_trajectory(job, "gpt")
    assert sorted(r["rank0"] for r in alive) == [0, 1]
    assert [n for n, _ in seq] == [3, 3, 2, 2, 2]
    events, _ = _check_reshards(job, "gpt", seq)
    assert events == [(3, 2, 2)]


def test_a_death_inside_a_commit_keeps_the_previous_commit(jobs):
    """Rank 2 dies inside the ring exchange of the commit of step 3:
    rank 1 recorded it, rank 0 did not.  The survivors agree on the
    commit of step 2 (the newest both hold), rank 1 drops its commit of
    step 3 (the redone step makes its own), and both redo step 3 at 2
    ranks on JAX's trajectory."""
    job = jobs["commit"]
    seq, alive = _check_trajectory(job, "commit")
    assert sorted(r["rank0"] for r in alive) == [0, 1]
    assert len(job["exclusions"]) == 1
    assert [n for n, _ in seq] == [3, 3, 2, 2, 2, 2]
    events, _ = _check_reshards(job, "commit", seq)
    assert events == [(3, 2, 2)]
    steps = {r["rank0"]: [(s["step"], s["n"]) for s in r["steps"]]
             for r in alive}
    # rank 1 finished step 3 (its commit recorded) before the failure
    # reached it; rank 0's step 3 failed in the exchange
    assert steps[1][:4] == [(1, 3), (2, 3), (3, 3), (3, 2)]
    assert steps[0][:3] == [(1, 3), (2, 3), (3, 2)]


def test_a_death_in_the_first_step_reshards_the_parameters_alone(jobs):
    """The constructor's commit holds p alone (torch makes Adam's moments
    at the first step): a death in step 1 re-shards it at 2 ranks with a
    fresh optimizer, on JAX's trajectory."""
    job = jobs["first"]
    seq, alive = _check_trajectory(job, "first")
    assert [n for n, _ in seq] == [2, 2, 2, 2]
    events, _ = _check_reshards(job, "first", seq)
    assert events == [(3, 2, 0)]


def test_two_adjacent_deaths_raise_on_no_survivor(jobs):
    """Rank 1 killed and rank 2 stopped with it at 3 ranks, rank 2
    killed 2 s later: excluded at two versions, the survivor waits at the
    first for rank 2, moves on when the second appears, and there rank
    1's block and its replica (on rank 2) are both gone: it raises rather
    than fresh-start."""
    job = jobs["double"]
    errs = [r["error"] for r in job["recs"] if r["error"]]
    assert len(errs) == 1, (job["error"], job["exclusions"], job["recs"])
    assert [e["removed"] for e in job["exclusions"]] == [
        ["127.0.0.1:31101"], ["127.0.0.1:31102"]]
    assert errs[0]["type"] == "ShardedStateError"
    assert "on no survivor" in errs[0]["message"]
    assert job["events"] == []


@pytest.mark.parametrize("planted", ["zero_replica", "wrong_offset"])
def test_planted_faults_fail_the_replay(jobs, planted):
    """Every re-shard of every job built from a zeroed replica misses
    JAX's state at M, and so does every one from more than one old block
    built with the new block length as the old one's (from one block,
    block 0 lies at 0 whatever the length)."""
    checked = 0
    for name in ("preempt", "cadence", "handoff", "gpt"):
        seq = tuple((s["n"], s["batch"]) for s in effective(
            max(_survivors(jobs[name]), key=lambda r: len(r["steps"]))))
        events, misses = _check_reshards(jobs[name], name, seq)
        for (old_n, _, _), miss in zip(events, misses[planted]):
            if planted == "zero_replica" or old_n > 1:
                assert miss > 1e-3, (name, events, misses)
                checked += 1
    assert checked == (6 if planted == "zero_replica" else 4)


def test_example_resizes_3_1_2(jobs):
    """The example resizes 3 -> 1 -> 2 and both workers that finish hold
    the same parameters."""
    got = jobs["example"]
    assert got["code"] == 0, got["stdout"][-3000:] + got["stderr"][-3000:]
    lines = got["stdout"].splitlines()
    done = [ln for ln in lines if "done: |w|^2" in ln]
    assert len(done) == 2 and len({ln.split("=")[-1] for ln in done}) == 1
    sizes = [int(ln.split("ranks=")[1].split()[0])
             for ln in lines if ln.startswith("step")]
    assert sizes == [3, 3, 1, 1, 2, 2]


# ------------------------------------------- layout, assembly, failures
@pytest.mark.parametrize("size,ndev,nproc", [(1, 1, 1), (68, 2, 2),
                                             (68, 3, 3), (1000, 8, 4),
                                             (7, 4, 1), (33, 4, 4)])
def test_layout_matches_jax(size, ndev, nproc):
    assert SH._layout(size, ndev, nproc) == jlayout(size, ndev, nproc)


def _jassemble(size, *args):
    tr = object.__new__(JSharded)
    tr._vec_size = size
    return tr._assemble(*args)


@pytest.mark.parametrize("size,old_n,new_n", [(68, 2, 1), (68, 1, 2),
                                              (68, 3, 1), (68, 1, 3),
                                              (70, 3, 2), (70, 2, 3),
                                              (5, 4, 3), (64, 4, 4)])
def test_assemble_matches_jax(size, old_n, new_n):
    """Every new rank's range from every subset of the old blocks, both
    packages' ``_assemble``."""
    rng = np.random.RandomState(size + 10 * old_n + new_n)
    _, _, old_block = jlayout(size, old_n, old_n)
    _, chunk, _ = jlayout(size, new_n, new_n)
    blocks = {r: rng.randn(old_block).astype(np.float32)
              for r in range(old_n)}
    tr = object.__new__(SH.ShardedElasticTrainer)
    tr._vec_size = size
    for me in range(new_n):
        lo, hi = min(me * chunk, size), min(size, (me + 1) * chunk)
        for keep in itertools.product([0, 1], repeat=old_n):
            got_np = {r: b for r, b in blocks.items() if keep[r]}
            want = _jassemble(size, "p", lo, hi, old_block, got_np,
                              np.float32)
            got = tr._assemble("p", lo, hi, old_block,
                               {r: torch.from_numpy(b)
                                for r, b in got_np.items()}, torch.float32)
            np.testing.assert_array_equal(got.numpy(), want)


def test_plan_spreads_sources_and_raises_on_a_lost_block():
    """The plan's sources are JAX's ``js[(me + r) % len(js)]``; a block
    on no member raises."""
    avail = [[1, 0, 1], [0, 0, 0], [1, 1, 0]]       # 3 old, 3 new ranks
    moves = SH.plan_transfers(avail, 4, 11, 4)
    want = []
    for dst in range(3):
        for r in range(3):
            a, b = max(dst * 4, r * 4), min((dst + 1) * 4, (r + 1) * 4, 11)
            if b > a and not avail[dst][r]:
                js = [j for j in range(3) if avail[j][r]]
                want.append((js[(dst + r) % len(js)], dst, r, a, b))
    assert moves == want and moves == [(2, 1, 1, 4, 8), (0, 2, 2, 8, 11)]
    with pytest.raises(SH.ShardedStateError, match="on no survivor"):
        SH.plan_transfers([[1, 0, 1]], 4, 12, 12)


def test_agree_commit_takes_the_newest_every_holder_has():
    slot = lambda s, n: {"samples": 8 * s, "steps": s, "n": n,
                         "names": ["p"], "rank": 0}
    hdrs = [{"slots": {5: slot(5, 3), 6: slot(6, 3)}},
            {"slots": {}},
            {"slots": {4: slot(4, 3), 5: slot(5, 3)}}]
    assert SH.agree_commit(hdrs)[0] == 5
    hdrs[2]["slots"] = {3: slot(3, 3), 4: slot(4, 3)}
    with pytest.raises(SH.ShardedStateError, match="lost commit 4"):
        SH.agree_commit(hdrs)
    hdrs[2]["slots"] = {5: slot(5, 3), 6: slot(6, 2)}
    with pytest.raises(SH.ShardedStateError, match="disagree"):
        SH.agree_commit(hdrs)


def test_a_resize_that_replaces_every_member_raises():
    tr = object.__new__(SH.ShardedElasticTrainer)
    with pytest.raises(SH.ShardedStateError, match="replaces every"):
        tr._pre_teardown(PeerList.parse("127.0.0.1:31100,127.0.0.1:31101"),
                         PeerList.parse("127.0.0.1:31102"))


def test_committed_progress_with_no_holder_raises(tmp_path):
    """Members that hold no commit while one of them has committed
    progress refuse a fresh start (a world of one in this process)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        tr = object.__new__(SH.ShardedElasticTrainer)
        tr.n, tr.rank, tr._vec_size = 1, 0, 68
        tr._slots, tr._held = {}, {}
        tr._committed_progress = (24, 3)
        tr.snapshot_every, tr._auto_snap, tr.config_version = 1, False, 2
        with pytest.raises(SH.ShardedStateError,
                           match=r"committed progress \(step 3\)"):
            tr._sync_state()
    finally:
        dist.destroy_process_group()


def test_range_digest_is_additive_over_any_layout():
    """``chip_smoke.range_digest``, the card's re-shard gate: the blocks'
    digests in any layout sum to the whole vector's; moved bits change
    it."""
    import chip_smoke as CS
    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.randn(70).astype(np.float32))
    whole = CS.range_digest(v, 0, 70)
    for n in (1, 2, 3, 4):
        _, chunk, _ = jlayout(70, n, n)
        padded = torch.cat([v, torch.zeros(chunk * n - 70)])
        assert sum(CS.range_digest(padded[r * chunk:(r + 1) * chunk],
                                   r * chunk, 70) for r in range(n)) == whole
    moved = v.clone()
    moved[[3, 4]] = moved[[4, 3]]                 # the same bits, moved
    assert CS.range_digest(moved, 0, 70) != whole
