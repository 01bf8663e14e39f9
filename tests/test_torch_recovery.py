"""Failure recovery in the port against the JAX package, on the CPU.

Every job runs three gloo ranks (one job four) of the port's
``DistributedElasticTrainer`` (processes spawned by the port's watcher,
meeting through versioned FileStores; no TCP port) under the port's
``ConfigServer``.  One rank is killed (SIGKILL inside its gradient
all-reduce, or inside an async commit after the join and before the
publish), terminated (SIGTERM between steps), stopped (SIGSTOP, found by
its expired lease), leaves its group without dying, or fails on its own
(a ValueError, an out-of-memory error).  The watcher turns a death into a compare-and-swap shrink;
the survivors abort the broken group, re-form at the new version, restore
the new rank 0's commit and redo the step.  In the four-rank job one
survivor's last publish is dropped, so rank 0 sends it its commit over a
subgroup.

The oracle is JAX's single-controller ``ElasticTrainer`` replaying the
(size, batch) sequence that ``_recover``'s semantics give: every step
trained, minus the steps a restore rewound, each at the size it ran at.
The sequence itself is asserted per job.  Tolerances are
tests/test_torch_elastic.py's: losses and parameters 1e-5 relative + 1e-6
absolute (f32), and for the 2-layer GPT losses 1e-5 and parameters 2e-5
absolute.  Each job's events (step, commit, sync, final) go through the
JAX package's ``kungfu_tpu.chaos.invariants`` checkers; two planted
faults must fail them: counters taken as a MAX of the survivors' live
counters, and the newest commit's counters over the previous commit's
state (what publishing progress before the state is joined gives).

Also here: the heartbeat, ``/health`` and ``propose_exclusion`` of each
package against the other's server, and the port's ``AsyncCommitter``
held to the contracts of tests/test_snapshot.py.
"""
import json
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kungfu_tpu.optimizers as kfopt
from kungfu_tpu.chaos import invariants as INV
from kungfu_tpu.elastic import ConfigServer as JServer
from kungfu_tpu.elastic import ElasticTrainer as JTrainer
from kungfu_tpu.elastic.heartbeat import HeartbeatSender as JSender
from kungfu_tpu.launcher.watch import propose_exclusion as jexclude
from kungfu_tpu.models import gpt as JG
from kungfu_tpu.ops.chunked_ce import chunked_cross_entropy as jce
from kungfu_tpu.plan import Cluster as JCluster, HostList as JHostList
from kungfu_tpu_torch.elastic import (AsyncCommitter, ConfigServer,
                                      HeartbeatSender, fetch_health,
                                      snapshot as SN)
from kungfu_tpu_torch.launcher import env as TE
from kungfu_tpu_torch.launcher.watch import (WorkerFailed, propose_exclusion,
                                             watch_run)
from kungfu_tpu_torch.plan import Cluster, HostList

REPO = Path(__file__).resolve().parents[1]
TOL = {"rtol": 1e-5, "atol": 1e-6}
GPT_TOL = {"loss": {"rtol": 1e-5, "atol": 1e-5},
           "params": {"rtol": 0, "atol": 2e-5}}
W_TRUE = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
GPT = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq=16, mlp="swiglu", rope=True)
GPT_LR, GPT_ROWS, CHUNK = 1e-3, 2, 32
SIZE = 3
# the quadratic problem's global batch: it splits over 4, 3 and 2 ranks
QUAD_ROWS = 24
# the lease job: leases renewed every 0.2 s from the step path; a
# survivor blocked on the stopped rank renews nothing until its
# collective times out, so the TTL exceeds that timeout plus a beat
LEASE = {"heartbeat_s": 0.2, "collective_timeout_s": 2.0,
         "lease_ttl_s": 5.0}

# name -> the job: optimizer, steps, snapshot cadence, the victim's rank,
# what it does and at which step count, a planted fault, and settings
JOBS = {
    "sgd_r2": dict(kind="sgd", act="kill_allreduce", victim=2, at=3),
    "adam_r2": dict(kind="adam", act="kill_allreduce", victim=2, at=3),
    "sgd_r0": dict(kind="sgd", act="kill_allreduce", victim=0, at=3),
    "adam_r0": dict(kind="adam", act="kill_allreduce", victim=0, at=3),
    "commit": dict(kind="adam", act="kill_commit", victim=0, at=4,
                   snapshot_every=2, steps=7),
    "rewind": dict(kind="adam", act="kill_allreduce", victim=2, at=5,
                   snapshot_every=2, steps=7),
    "fault_max": dict(kind="adam", act="kill_allreduce", victim=2, at=5,
                      snapshot_every=2, steps=7, fault="max_counters"),
    "fault_stale": dict(kind="adam", act="kill_allreduce", victim=2, at=3,
                        fault="stale_state"),
    "term": dict(kind="sgd", act="term", victim=1, at=2),
    "exit3": dict(kind="sgd", act="exit3", victim=1, at=2),
    "stop": dict(kind="sgd", act="stop", victim=2, at=2, **LEASE),
    "no_version": dict(kind="sgd", act="leave", victim=2, at=2,
                       recover_timeout=2.0),
    "gpt": dict(kind="gpt", act="kill_allreduce", victim=2, at=2, steps=5),
    "auto": dict(kind="adam", act="kill_allreduce", victim=2, at=5,
                 snapshot_every="auto", steps=7),
    "user_error": dict(kind="sgd", act="bad_batch", victim=1, at=2),
    "oom": dict(kind="sgd", act="oom", victim=1, at=2),
    # 4 -> 3: rank 2 drops its publish of the commit of step 3, rank 3
    # dies in step 4's all-reduce; rank 2's commit differs from rank 0's
    "differ": dict(kind="adam", act="kill_allreduce", victim=3, at=3,
                   size=4, drop=2),
}


def quad_batch(step, rows=QUAD_ROWS):
    """tests/test_elastic.py's ``batch_for``, drawn for the job's first
    size: the global batch stays, the ranks' blocks grow at a shrink."""
    rng = np.random.RandomState(step)
    x = rng.randn(rows, 4).astype(np.float32)
    return x, x @ W_TRUE


def gpt_batch(step, rows=GPT_ROWS * SIZE):
    toks = np.random.RandomState(100 + step).randint(
        0, GPT["vocab_size"], (rows, GPT["max_seq"])).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def w0():
    return np.random.RandomState(0).randn(4, 1).astype(np.float32)


WORKER = textwrap.dedent("""
    import json, os, pickle, signal, sys, threading, time
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed as D
    from kungfu_tpu_torch.convert import params_from_jax
    from kungfu_tpu_torch.elastic import DistributedElasticTrainer
    from kungfu_tpu_torch.launcher import env as E
    from kungfu_tpu_torch.models import gpt as TG
    from kungfu_tpu_torch.ops.chunked_ce import chunked_cross_entropy
    from kungfu_tpu_torch.optimizers import sync_sgd as SS
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.utils.tree import tree_leaves

    torch.set_num_threads(1)
    job = json.load(open(sys.argv[1]))
    out, plan = job["out"], job["plan"]
    we = E.install(E.parse(sys.argv[2:]))
    rank0 = we.rank()
    stream = f"{we.self_spec.port}.{os.getpid()}"
    lock = threading.Lock()
    W_TRUE = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    victim = rank0 == job["victim"] and we.cluster_version == 1

    def emit(kind, **kw):
        kw.update(kind=kind, stream=stream)
        with lock, open(f"{out}/events.{stream}.jsonl", "a") as f:
            f.write(json.dumps(kw) + "\\n")
            f.flush()
            os.fsync(f.fileno())

    def quad(p, batch):
        if victim and job["act"] == "oom" and tr.step_count == job["at"]:
            raise torch.OutOfMemoryError("CUDA out of memory (planted)")
        x, y = batch
        return ((x @ p["w"] - y) ** 2).mean()

    def quad_batch(step):
        rng = np.random.RandomState(step)
        x = rng.randn(plan["quad_rows"], 4).astype(np.float32)
        return torch.from_numpy(x), torch.from_numpy(x @ W_TRUE)

    cfg = TG.GPTConfig(dtype=torch.float32, **plan["gpt"])

    def gpt_loss(p, batch):
        bt, by = batch
        feats = TG.forward_features(p, bt, cfg, attn="flash")
        return chunked_cross_entropy(feats, p["lm_head"], by,
                                     plan["chunk"]).mean()

    def gpt_batch(step):
        toks = np.random.RandomState(100 + step).randint(
            0, cfg.vocab_size, (plan["gpt_rows"] * job["size"], cfg.max_seq))
        toks = torch.from_numpy(toks.astype(np.int32))
        return toks, torch.roll(toks, -1, dims=1)

    def factory(leaves, n):
        kind = job["kind"]
        if kind == "sgd":
            base = torch.optim.SGD(leaves, lr=0.1)
        elif kind == "adam":
            base = torch.optim.Adam(leaves, lr=1e-2, betas=(0.9, 0.999),
                                    eps=1e-8)
        else:
            base = torch.optim.AdamW(leaves, lr=plan["gpt_lr"],
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=1e-4)
        return synchronous_sgd(base)

    if job["kind"] == "gpt":
        if rank0 == 0:
            with open(job["gpt_weights"], "rb") as f:
                params = params_from_jax(pickle.load(f), cfg)
        else:
            params = TG.init_params(torch.Generator().manual_seed(rank0), cfg)
        loss_fn, batch_of = gpt_loss, gpt_batch
    else:
        params = {"w": torch.from_numpy(np.load(job["w0"]) + rank0)}
        loss_fn, batch_of = quad, quad_batch

    tr = None
    real_mean = SS.cross_replica_mean_gradients

    def mean_then_die(grads, group=None, fusion=False):
        # the victim dies inside its gradient all-reduce: the all-reduce
        # runs on a thread, and the process is killed 10 ms into it
        if victim and tr.step_count == job["at"]:
            threading.Thread(target=real_mean, args=(grads, group, fusion),
                             daemon=True).start()
            time.sleep(0.01)
            os.kill(os.getpid(), signal.SIGKILL)
        return real_mean(grads, group, fusion)
    if job["act"] == "kill_allreduce":
        SS.cross_replica_mean_gradients = mean_then_die

    tr = DistributedElasticTrainer(
        loss_fn, factory, params, backend="gloo",
        snapshot_every=job["snapshot_every"],
        recover_timeout=job["recover_timeout"],
        collective_timeout_s=job["collective_timeout_s"],
        heartbeat_s=job["heartbeat_s"])
    previous = [None]
    real_publish = tr._publish

    def publish(host, devices, progress):
        if victim and job["act"] == "kill_commit" and progress[1] == job["at"]:
            os.kill(os.getpid(), signal.SIGKILL)     # joined, not published
        if (rank0 == job.get("drop") and progress[1] == job["at"]
                and not tr.recoveries):
            return                       # this commit is never published
        previous[0] = tr._committed
        real_publish(host, devices, progress)
        emit("commit", samples=progress[0], step=progress[1])
    tr._publish = publish
    emit("commit", samples=tr.committed_progress[0],
         step=tr.committed_progress[1])
    if job["fault"] == "max_counters":
        real_restore = tr._restore_committed

        def restore_max():
            live = (tr.trained_samples, tr.step_count)
            moved = real_restore()
            tr.trained_samples = tr._agree(live[0], "MAX")
            tr.step_count = tr._agree(live[1], "MAX")
            return moved
        tr._restore_committed = restore_max
    elif job["fault"] == "stale_state":
        tr._committed_record = lambda: (*previous[0][:2], tr._committed[2])

    def wsum():
        return float(sum(float((t.double() ** 2).sum())
                         for t in tree_leaves(tr.params)))

    emit("start", rank=tr.rank, size=tr.n, version=tr.version,
         step=tr.step_count, samples=tr.trained_samples)
    rec = {"rank0": rank0, "steps": [], "error": None}
    seen = 0
    while tr.step_count < job["steps"]:
        i = tr.step_count
        if victim and i == job["at"]:
            if job["act"] == "kill_commit":
                time.sleep(60)      # the committer thread kills this rank
            elif job["act"] == "term":
                os.kill(os.getpid(), signal.SIGTERM)
            elif job["act"] == "exit3":
                sys.exit(3)
            elif job["act"] == "stop":
                os.kill(os.getpid(), signal.SIGSTOP)
            elif job["act"] == "leave":
                D.abort()
                os._exit(0)
        batch = batch_of(i)
        if victim and i == job["at"] and job["act"] == "bad_batch":
            batch = tuple(t[:-1] for t in batch)   # rows not divisible
        t0 = time.monotonic()
        try:
            loss = tr.step(batch)
        except RuntimeError as e:
            if isinstance(e, torch.OutOfMemoryError):
                raise
            rec["error"] = {"type": type(e).__name__, "message": str(e),
                            "seconds": time.monotonic() - t0}
            break
        if loss is None:
            emit("detached", step=tr.step_count, samples=tr.trained_samples)
            rec["detached"] = True
            break
        for r in tr.recoveries[seen:]:
            emit("sync", samples=r["restored"][0], step=r["restored"][1],
                 size=r["size"], version=r["version"])
        seen = len(tr.recoveries)
        rec["steps"].append({"batch": i, "n": tr.n, "step": tr.step_count,
                             "loss": loss})
        emit("step", rank=tr.rank, size=tr.n, version=tr.version,
             step=tr.step_count, samples=tr.trained_samples)
    if rec["error"] is None and not rec.get("detached"):
        tr._committer.drain()
        emit("final", rank=tr.rank, size=tr.n, version=tr.version,
             step=tr.step_count, samples=tr.trained_samples, wsum=wsum())
        rec["final"] = [float(v) for t in tree_leaves(tr.params)
                        for v in t.detach().reshape(-1)]
        rec["moments"] = [float(v) for st in tr.optimizer.state.values()
                          for k in ("exp_avg", "exp_avg_sq") if k in st
                          for v in st[k].reshape(-1)]
        rec["samples"] = tr.trained_samples
        rec["version"], rec["size"] = tr.version, tr.n
    rec["recoveries"] = tr.recoveries
    rec["snapshot_every"] = tr.snapshot_every
    with open(f"{out}/rec.{rank0}.json", "w") as f:
        json.dump(rec, f)
    if rec["error"] is None:
        tr.shutdown()
""")


def _jgpt():
    cfg = JG.GPTConfig(dtype=jnp.float32, **GPT)
    return cfg, JG.init_params(jax.random.PRNGKey(0), cfg)


def _run_job(name, tmp):
    spec = {"kind": "sgd", "steps": 6, "snapshot_every": 1, "fault": None,
            "recover_timeout": 60.0,
            "collective_timeout_s": 60.0, "heartbeat_s": 0.0,
            "lease_ttl_s": 0.0, **JOBS[name]}
    size = spec.get("size", SIZE)
    out = tmp / name
    out.mkdir()
    job = dict(spec, size=size, out=str(out), w0=str(tmp / "w0.npy"),
               gpt_weights=str(tmp / "gpt.pkl"),
               plan={"gpt": GPT, "gpt_rows": GPT_ROWS, "gpt_lr": GPT_LR,
                     "chunk": CHUNK, "quad_rows": QUAD_ROWS})
    (out / "job.json").write_text(json.dumps(job))
    srv = ConfigServer().start()
    srv.put_cluster(Cluster.from_hostlist(HostList.parse("127.0.0.1:4"),
                                          size))
    exclusions, error = [], None

    def argv_for(rank, cluster, version):
        return [sys.executable, "-c", WORKER, str(out / "job.json"),
                *TE.worker_argv(rank, cluster.workers, version, srv.url,
                                str(out / "rdzv"), spec["heartbeat_s"])]
    t0 = time.monotonic()
    try:
        exits = watch_run(srv, argv_for, str(out), poll_interval=0.1,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          cwd=str(REPO), timeout=150,
                          lease_ttl_s=spec["lease_ttl_s"],
                          exclusions=exclusions)
    except WorkerFailed as e:
        exits, error = None, str(e)
    finally:
        final_version = srv.get_cluster()[0]
        srv.stop()
    events = []
    for f in sorted(out.glob("events.*.jsonl")):
        events += [json.loads(ln) for ln in f.read_text().splitlines()]
    recs = {}
    for f in out.glob("rec.*.json"):
        r = json.loads(f.read_text())
        recs[r["rank0"]] = r
    return {"exits": exits, "error": error, "events": events, "recs": recs,
            "exclusions": exclusions, "server_version": final_version,
            "seconds": time.monotonic() - t0}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every job, run once for the module, a few at a time."""
    tmp = tmp_path_factory.mktemp("recovery")
    np.save(tmp / "w0.npy", w0())
    _, jp = _jgpt()
    with open(tmp / "gpt.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jp), f)
    # the lease job first and alone: its collective timeout is short
    got = {"stop": _run_job("stop", tmp)}
    with ThreadPoolExecutor(4) as pool:
        futures = {n: pool.submit(_run_job, n, tmp) for n in JOBS
                   if n != "stop"}
        got.update({n: f.result() for n, f in futures.items()})
    return got


def effective(rec):
    """The (size, batch) of every step that stands: a step a restore
    rewound is replaced by the step trained at its count later."""
    by_step = {}
    for s in rec["steps"]:
        by_step[s["step"]] = s
    return [(by_step[k]["n"], by_step[k]["batch"], by_step[k]["loss"])
            for k in sorted(by_step)]


def jax_replay(kind, seq):
    """JAX's ElasticTrainer on ``seq`` ((size, batch) pairs): its losses,
    its final parameters flattened in sorted-key order, and the wsum
    after every step by the trained samples."""
    if kind == "gpt":
        cfg, params = _jgpt()

        def loss_fn(p, batch):
            bt, by = batch
            feats = JG.forward_features(p, bt, cfg, attn="flash")
            return jce(feats, p["lm_head"].astype(cfg.dtype), by,
                       CHUNK).mean()
        opt, batch_of = optax.adamw(GPT_LR), gpt_batch
    else:
        params = {"w": jnp.asarray(w0())}

        def loss_fn(p, batch):
            x, y = batch
            return jnp.mean((x @ p["w"] - y) ** 2)
        opt = optax.adam(1e-2) if kind == "adam" else optax.sgd(0.1)
        batch_of = quad_batch
    tr = JTrainer(loss_fn, lambda n: kfopt.synchronous_sgd(opt), params,
                  init_size=seq[0][0])
    losses, wsums = [], {}
    for n, b in seq:
        tr.resize(n)
        losses.append(tr.step(tuple(jnp.asarray(a) for a in batch_of(b))))
        leaves = jax.tree_util.tree_leaves(tr.current_params())
        wsums[tr.trained_samples] = float(sum(
            np.square(np.asarray(t, np.float64)).sum() for t in leaves))
    final = np.concatenate([np.asarray(t).reshape(-1) for t in
                            jax.tree_util.tree_leaves(tr.current_params())])
    return np.asarray(losses), final, wsums


def survivors(job):
    return {r: rec for r, rec in job["recs"].items() if "final" in rec}


def violations(job, kind, seq):
    _, _, wsums = jax_replay(kind, seq)
    init = float(np.square(w0().astype(np.float64)).sum())
    ev = job["events"]
    return (INV.check_progress_monotonic(ev)
            + INV.check_sync_from_committed(ev)
            + INV.check_single_winner(ev)
            + INV.check_no_fresh_start(ev, init_wsum=init)
            + INV.check_trajectory(ev, lambda s: wsums.get(s, float("nan"))))


def _expected(spec, every=None):
    """The (size, batch) sequence ``_recover``'s semantics give: the step
    of batch ``at`` fails (the victim dies in it, or before it, or in the
    commit of the step count ``at``), the survivors restore the last
    commit and train the caller's batch on it, and the caller draws on
    from the rewound step count."""
    steps = spec.get("steps", 6)
    size = spec.get("size", SIZE)
    every = every or spec.get("snapshot_every", 1)
    at = spec["at"]
    last = at - at % every
    if spec.get("snapshot_every") == "auto":
        last = max(last, 1)     # the commit measured at step 1
    return ([(size, b) for b in range(last)] + [(size - 1, at)]
            + [(size - 1, b) for b in range(last + 1, steps)])


def _check_sound(job, name, kind, tol=TOL, gpt=False):
    spec = JOBS[name]
    size = spec.get("size", SIZE)
    assert job["error"] is None, job["error"]
    assert len(job["exclusions"]) == 1, job["exclusions"]
    alive = survivors(job)
    assert sorted(alive) == sorted(set(range(size)) - {spec["victim"]})
    first = alive[min(alive)]
    seq = [(n, b) for n, b, _ in effective(first)]
    assert seq == _expected(spec, first["snapshot_every"]), seq
    losses, final, _ = jax_replay(kind, seq)
    got = np.asarray([loss for _, _, loss in effective(first)])
    if gpt:
        np.testing.assert_allclose(got, losses, **GPT_TOL["loss"])
        np.testing.assert_allclose(first["final"], final,
                                   **GPT_TOL["params"])
    else:
        np.testing.assert_allclose(got, losses, **tol)
        np.testing.assert_allclose(first["final"], final, **tol)
    # the survivors end bit for bit equal, at one (version, size), having
    # counted every step that stands once
    for r in alive.values():
        assert r["final"] == first["final"]
        assert r["moments"] == first["moments"]
        assert (r["version"], r["size"]) == (2, size - 1)
        assert len(r["recoveries"]) == 1
        rows = QUAD_ROWS if kind != "gpt" else GPT_ROWS * SIZE
        assert r["samples"] == rows * spec.get("steps", 6)
    assert violations(job, kind, seq) == []
    return alive


@pytest.mark.parametrize("name", ["sgd_r2", "adam_r2", "sgd_r0",
                                  "adam_r0"])
def test_killed_in_the_gradient_all_reduce_becomes_a_shrink(jobs, name):
    job = jobs[name]
    alive = _check_sound(job, name, JOBS[name]["kind"])
    victim = JOBS[name]["victim"]
    assert job["exclusions"][0]["removed"] == [f"127.0.0.1:{31100 + victim}"]
    assert job["exits"][f"127.0.0.1_{31100 + victim}_v1"] == -signal.SIGKILL
    rec = next(iter(alive.values()))["recoveries"][0]
    assert rec["from_size"] == SIZE and rec["rewound"] == 0
    # one commit at every step: the survivors hold equal commits, and
    # nothing moves at the restore
    assert all(r["recoveries"][0]["restore_bytes"] == 0
               for r in alive.values())
    # the new ranks keep the old order without the victim
    ranks = sorted((r["recoveries"][0]["rank"], r0) for r0, r in
                   alive.items())
    assert [r0 for _, r0 in ranks] == sorted(alive)


def test_killed_inside_an_async_commit_restores_the_published_one(jobs):
    """Rank 0 dies after its commit of step 4 was joined and before it
    was published; the new rank 0 (the old rank 1) published its own."""
    job = jobs["commit"]
    alive = _check_sound(job, "commit", "adam")
    commits = {(e["samples"], e["step"]) for e in job["events"]
               if e["kind"] == "commit" and e["stream"].startswith("31100.")}
    assert (QUAD_ROWS * 4, 4) not in commits
    assert all(r["recoveries"][0]["restored"] == [QUAD_ROWS * 4, 4]
               for r in alive.values())


def test_a_restore_rewinds_to_the_last_commit(jobs):
    """snapshot_every=2, a death at step 5: the survivors rewind one step
    to the commit of step 4 and train the caller's batch 5 on it."""
    job = jobs["rewind"]
    alive = _check_sound(job, "rewind", "adam")
    for r in alive.values():
        assert r["recoveries"][0]["rewound"] == 1
        assert r["recoveries"][0]["restored"] == [QUAD_ROWS * 4, 4]


@pytest.mark.parametrize("name", ["fault_max", "fault_stale"])
def test_planted_restore_faults_fail_the_checks(jobs, name):
    job = jobs[name]
    spec = JOBS[name]
    assert job["error"] is None, job["error"]
    first = survivors(job)[min(survivors(job))]
    seq = [(n, b) for n, b, _ in effective(first)]
    bad = violations(job, spec["kind"], seq)
    if name == "fault_max":
        assert any("no worker ever recorded as a commit" in v for v in bad)
    else:
        # counters of step 3 over the state of step 2: every check of
        # the counters holds, the trajectory does not
        assert seq == _expected(spec)
        assert any("!= oracle" in v for v in bad), bad
        losses, final, _ = jax_replay(spec["kind"], seq)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(first["final"], final, **TOL)


def test_sigterm_between_steps_becomes_a_shrink(jobs):
    job = jobs["term"]
    _check_sound(job, "term", "sgd")
    assert job["exits"]["127.0.0.1_31101_v1"] == -signal.SIGTERM
    assert job["exclusions"][0]["cause"] == "killed"


def test_another_exit_code_fails_the_job(jobs):
    job = jobs["exit3"]
    assert job["exits"] is None and "exited 3" in job["error"]
    assert job["exclusions"] == [] and job["server_version"] == 1


def test_a_stopped_rank_is_excluded_by_its_lease(jobs):
    """SIGSTOP: the rank's lease ages past the TTL; the watcher excludes
    it and kills its process group, and the survivors, whose collective
    timed out, re-form without it."""
    job = jobs["stop"]
    alive = _check_sound(job, "stop", "sgd")
    assert job["exclusions"][0]["cause"] == "lease"
    assert job["exclusions"][0]["removed"] == ["127.0.0.1:31102"]
    assert job["exits"]["127.0.0.1_31102_v1"] == -signal.SIGKILL
    # a survivor's collective timed out (the other may instead have seen
    # the first one leave the group)
    assert any("Timed out" in r["recoveries"][0]["cause"]
               for r in alive.values())


def test_no_new_version_raises_the_original_error(jobs):
    """A rank leaves the group without dying: no exclusion comes, and
    after recover_timeout the survivors raise gloo's own error."""
    job = jobs["no_version"]
    assert job["error"] is None and job["exclusions"] == []
    errs = [r["error"] for r in job["recs"].values() if r["error"]]
    assert len(errs) == 2
    for e in errs:
        assert e["type"] == "RuntimeError"
        assert "Connection closed" in e["message"] or \
            "Connection reset" in e["message"], e
        assert e["seconds"] >= JOBS["no_version"]["recover_timeout"]


def test_auto_cadence_is_agreed_and_recovered_from(jobs):
    """snapshot_every="auto": a commit measured at step 1, the cadence
    derived at step 2 and taken as the MAX over the group; the recovery
    rewinds to the last commit at that cadence."""
    alive = _check_sound(jobs["auto"], "auto", "adam")
    every = {r["snapshot_every"] for r in alive.values()}
    assert len(every) == 1 and every.pop() >= 1


def test_a_callers_value_error_is_not_a_dead_peer(jobs):
    """A ValueError from the step (a batch whose rows do not split over
    the ranks) propagates: the rank fails the job and no exclusion is
    proposed."""
    job = jobs["user_error"]
    assert job["exits"] is None and "ValueError" in job["error"]
    assert "not divisible" in job["error"]
    assert job["exclusions"] == [] and job["server_version"] == 1


def test_an_out_of_memory_error_is_not_a_dead_peer(jobs):
    """An out-of-memory error of the rank's own card propagates: the job
    fails at once with it, and no rank waits out ``recover_timeout``."""
    job = jobs["oom"]
    assert job["exits"] is None and "OutOfMemoryError" in job["error"]
    assert "exited 1" in job["error"]
    assert job["exclusions"] == [] and job["server_version"] == 1
    assert job["seconds"] < 60.0     # the job's recover_timeout


def test_a_survivor_with_another_commit_receives_rank_0s(jobs):
    """Four ranks; rank 2's publish of the commit of step 3 is dropped
    (a survivor a step behind), and rank 3 dies in step 4's all-reduce.
    Rank 2's pair and digest differ from rank 0's: rank 0 sends it its
    commit over a subgroup of the two, rank 1 restores its own, and the
    three end bit for bit equal on JAX's trajectory."""
    job = jobs["differ"]
    alive = _check_sound(job, "differ", "adam")
    recs = {r0: r["recoveries"][0] for r0, r in alive.items()}
    assert all(r["restored"] == [QUAD_ROWS * 3, 3] for r in recs.values())
    assert recs[0]["restore_bytes"] > 0
    assert recs[2]["restore_bytes"] == recs[0]["restore_bytes"]
    assert recs[1]["restore_bytes"] == 0
    dropped = {(e["samples"], e["step"]) for e in job["events"]
               if e["kind"] == "commit" and e["stream"].startswith("31102.")}
    assert (QUAD_ROWS * 3, 3) not in dropped
    assert (QUAD_ROWS * 2, 2) in dropped


def test_gpt_recovers_from_a_kill_as_jax(jobs):
    _check_sound(jobs["gpt"], "gpt", "gpt", gpt=True)


# ------------------------------------------- the wire, both packages
def _cluster(mod_cluster, mod_hosts, n):
    return mod_cluster.from_hostlist(mod_hosts.parse("127.0.0.1:4"), n)


@pytest.mark.parametrize("sender", ["port", "jax"])
def test_heartbeats_reach_either_server(sender):
    """The port's sender against JAX's server and JAX's against the
    port's: the lease appears in /health with the same fields."""
    srv = (JServer if sender == "port" else ConfigServer)().start()
    cls = HeartbeatSender if sender == "port" else JSender
    hb = cls(srv.url, "h1:31100", interval_s=0.1)
    try:
        assert hb.beat(rank=2, step=7, version=3)
        assert not hb.beat(rank=2, step=8, version=3)   # within interval
        t_end = time.monotonic() + 10
        while "h1:31100" not in fetch_health(srv.url)["leases"]:
            assert time.monotonic() < t_end
            time.sleep(0.02)
        health = fetch_health(srv.url)
        lease = health["leases"]["h1:31100"]
        assert sorted(lease) == ["age_s", "beats", "rank", "step",
                                 "version"]
        assert (lease["rank"], lease["step"], lease["version"],
                lease["beats"]) == (2, 7, 3, 1)
        assert sorted(health) == ["epoch", "leases", "version"]
    finally:
        hb.stop()
        srv.stop()


def _raw(url, method, body=None):
    import urllib.request
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_heartbeat_and_health_bodies_are_byte_equal():
    ours, theirs = ConfigServer().start(), JServer().start()
    try:
        got = []
        for srv in (ours, theirs):
            base = srv.url[:-len("/config")]
            beats = [_raw(base + "/heartbeat", "POST", b)[0] for b in (
                b'{"peer": "h:1", "rank": 0, "step": 1, "version": 0}',
                b'{"rank": 0}', b"not json",
                b'{"peer": "h:1", "step": 2}')]
            bad = _raw(base + "/heartbeat", "POST", b"not json")[1]
            code, body = _raw(base + "/health", "GET")
            body = json.loads(body)
            body["epoch"] = "E"
            body["leases"]["h:1"]["age_s"] = "A"
            ok = _raw(base + "/heartbeat", "POST", b'{"peer": "h:2"}')[1]
            got.append((beats, bad, code, json.dumps(body),
                        json.loads(ok)["ok"], sorted(json.loads(ok))))
    finally:
        ours.stop()
        theirs.stop()
    assert got[0] == got[1]
    assert got[0][0] == [200, 400, 400, 200]
    assert '"beats": 2' in got[0][3] and '"rank": null' in got[0][3]


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_propose_exclusion_across_packages(server, client):
    srv = (ConfigServer if server == "port" else JServer)().start()
    removed = []

    def exclude(url, dead):
        if client == "jax":
            return jexclude(url, dead)
        v, changed = propose_exclusion(url, dead)
        removed.append(changed)
        return v
    from kungfu_tpu_torch.plan import PeerID as TPeer
    from kungfu_tpu.plan import PeerID as JPeer
    peer = TPeer if client == "port" else JPeer
    try:
        c = _cluster(Cluster, HostList, 3)
        srv_put = srv.put_cluster if server == "port" else (
            lambda cl: srv.put_cluster(JCluster.from_json(cl.to_json())))
        srv_put(c)
        dead = {peer.parse("127.0.0.1:31102:2")}
        assert exclude(srv.url, dead) == 2
        v, got = srv.get_cluster()
        assert v == 2 and [str(w) for w in got.workers] == [
            "127.0.0.1:31100", "127.0.0.1:31101"]
        assert exclude(srv.url, dead) == 2          # absorbed already
        both = {peer.parse("127.0.0.1:31100:0"),
                peer.parse("127.0.0.1:31101:1")}
        assert exclude(srv.url, both) is None       # would empty it
        assert srv.get_cluster()[0] == 2
        assert removed == ([True, False, False] if client == "port" else [])
    finally:
        srv.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_a_lost_exclusion_race_backs_off_and_retries(monkeypatch, client):
    """The CAS loser (the port's against JAX's server, JAX's against the
    port's) pauses with jitter, refetches, and removes the dead from the
    winner's cluster."""
    import kungfu_tpu.launcher.watch as JW
    from kungfu_tpu.utils import rpc as JRPC
    from kungfu_tpu_torch.launcher import watch as W
    from kungfu_tpu_torch.plan import PeerID
    from kungfu_tpu.plan import PeerID as JPeer
    srv = (JServer if client == "port" else ConfigServer)().start()
    mod = W if client == "port" else JW
    sleeps = []
    try:
        c4 = _cluster(Cluster, HostList, 4)
        srv.put_cluster(c4 if client == "jax" else JCluster.from_json(
            c4.to_json()))
        real_put = mod.put_config

        def racing_put(url, cluster, if_version=None, **kw):
            if not sleeps:        # another proposal lands first
                real_put(url, type(cluster).from_json(
                    _cluster(Cluster, HostList, 3).to_json()))
            return real_put(url, cluster, if_version=if_version, **kw)
        monkeypatch.setattr(mod, "put_config", racing_put)
        if client == "port":
            real_sleep = time.sleep
            monkeypatch.setattr(W.time, "sleep", lambda d: (
                sleeps.append(d), real_sleep(d)))
            dead = {PeerID("127.0.0.1", 31101, 1)}

            def exclude(url, dead):
                v, changed = propose_exclusion(url, dead)
                assert changed
                return v
        else:
            real = JRPC.Backoff.sleep
            monkeypatch.setattr(JRPC.Backoff, "sleep", lambda self: (
                sleeps.append(self.attempt), real(self))[1])
            dead = {JPeer("127.0.0.1", 31101, 1)}
            exclude = jexclude
        assert exclude(srv.url, dead) == 3
        assert len(sleeps) == 1
        assert [str(w) for w in srv.get_cluster()[1].workers] == [
            "127.0.0.1:31100", "127.0.0.1:31102"]
    finally:
        srv.stop()
    if client == "port":
        assert 0 <= sleeps[0] <= W.BACKOFF_BASE_S


def test_watcher_keeps_the_dead_queued_while_the_server_is_down(tmp_path):
    """A killed worker while the config server cannot be reached: the
    watcher neither crashes nor respawns it, and excludes it once the
    server is back."""
    from kungfu_tpu_torch.plan import PeerID
    srv = ConfigServer().start()
    c = Cluster.from_hostlist(HostList.parse("127.0.0.1:4"), 2)
    srv.put_cluster(c)
    port = srv.port
    flag = tmp_path / "go"
    script = textwrap.dedent(f"""
        import os, signal, sys, time
        rank = int(sys.argv[1])
        t_end = time.monotonic() + 60
        while not os.path.exists({str(flag)!r}):
            if time.monotonic() > t_end:
                sys.exit(5)
            time.sleep(0.02)
        if rank == 1:
            os.kill(os.getpid(), signal.SIGKILL)
        while not os.path.exists({str(tmp_path / 'done')!r}):
            if time.monotonic() > t_end:
                sys.exit(5)
            time.sleep(0.02)
    """)
    exclusions, got = [], {}

    def watch():
        try:
            got["exits"] = watch_run(
                f"http://127.0.0.1:{port}/config",
                lambda r, cl, v: [sys.executable, "-c", script, str(r)],
                str(tmp_path), poll_interval=0.05, timeout=60,
                exclusions=exclusions)
        except Exception as e:
            got["error"] = e
    th = threading.Thread(target=watch)
    th.start()
    try:
        time.sleep(1.0)
        srv.stop()                        # the server goes away
        flag.touch()                      # rank 1 dies meanwhile
        time.sleep(1.5)
        assert th.is_alive() and exclusions == []
        srv = ConfigServer(port=port).start()
        srv.put_cluster(c)
        t_end = time.monotonic() + 20
        while not exclusions:
            assert time.monotonic() < t_end and th.is_alive()
            time.sleep(0.05)
        (tmp_path / "done").touch()
        th.join(30)
    finally:
        (tmp_path / "done").touch()
        th.join(30)
        srv.stop()
    assert not th.is_alive() and "error" not in got, got.get("error")
    assert exclusions[0]["removed"] == ["127.0.0.1:31101"]
    assert got["exits"] == {"127.0.0.1_31100_v1": 0,
                            "127.0.0.1_31101_v1": -signal.SIGKILL}
    assert [str(w) for w in srv.get_cluster()[1].workers] == [
        str(PeerID("127.0.0.1", 31100))]


# ------------------------------------- the committer's contracts
class _SlowJoin:
    """A PendingSnapshot whose join waits ``delay`` seconds, or fails."""

    def __init__(self, tree, delay=0.0, fail=False):
        self.tree, self.delay, self.fail = tree, delay, fail
        self.dispatch_s = self.join_s = 0.0
        self.nbytes = SN.tree_nbytes(tree)
        self._tree = tree

    def fence(self):
        pass

    def join(self):
        if self.fail:
            raise RuntimeError("injected join failure")
        time.sleep(self.delay)
        return self.tree


@pytest.fixture
def slow(monkeypatch):
    """Make every dispatch of the committer a _SlowJoin of the settings
    ``cfg`` holds."""
    cfg = {"delay": 0.0, "fail": False}
    monkeypatch.setattr(SN, "dispatch", lambda tree, into=None: _SlowJoin(
        {k: v.clone() for k, v in tree.items()}, **cfg))
    return cfg


def test_committer_initiate_returns_before_publish(slow):
    slow["delay"] = 0.15
    cm = AsyncCommitter()
    try:
        published = []
        t0 = time.perf_counter()
        cm.initiate({"p": torch.arange(8.0)}, published.append)
        assert time.perf_counter() - t0 < 0.1
        assert published == []
        cm.drain()
        assert len(published) == 1 and torch.equal(published[0]["p"],
                                                    torch.arange(8.0))
    finally:
        cm.close()


def test_committer_single_inflight_publishes_in_order(slow, monkeypatch):
    slow["delay"] = 0.02
    order = []
    slow_dispatch = SN.dispatch
    monkeypatch.setattr(SN, "dispatch", lambda tree, into=None: (
        order.append("dispatch"), slow_dispatch(tree, into))[1])
    cm = AsyncCommitter()
    try:
        for i in range(4):
            cm.initiate({"p": torch.full((4,), float(i))},
                        lambda h, i=i: order.append(i))
        cm.drain()
        # each dispatch waits until the commit before it has published
        assert order == ["dispatch", 0, "dispatch", 1, "dispatch", 2,
                         "dispatch", 3]
    finally:
        cm.close()


def test_committer_failed_join_reraises_and_recovers(slow):
    cm = AsyncCommitter()
    try:
        published = []
        cm.initiate({"p": torch.ones(4)}, lambda h: published.append("ok1"))
        cm.drain()
        slow["fail"] = True
        cm.initiate({"p": torch.ones(4)}, lambda h: published.append("bad"))
        with pytest.raises(RuntimeError, match="injected join failure"):
            cm.drain()
        slow["fail"] = False
        cm.initiate({"p": torch.ones(4)}, lambda h: published.append("ok2"))
        cm.drain()
        assert published == ["ok1", "ok2"]
        # a failure is also raised at the next initiate
        slow["fail"] = True
        cm.initiate({"p": torch.ones(4)}, lambda h: None)
        slow["fail"] = False
        with pytest.raises(RuntimeError, match="injected join failure"):
            while True:
                cm.initiate({"p": torch.ones(4)}, lambda h: None)
    finally:
        cm.close()


def test_committer_publish_is_atomic_state_then_progress(slow):
    slow["delay"] = 0.05
    cm = AsyncCommitter()
    state = {"record": None}
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            rec = state["record"]
            if rec is not None:
                seen.append(rec[0] is not None and rec[1] == (8, 1))

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        cm.initiate({"p": torch.ones(16)},
                    lambda host: state.update(record=(host, (8, 1))))
        cm.drain()
        time.sleep(0.01)
    finally:
        stop.set()
        t.join(timeout=5)
        cm.close()
    assert not t.is_alive()
    assert state["record"][1] == (8, 1) and seen and all(seen)


def test_committer_close_rejects_new_work():
    cm = AsyncCommitter()
    cm.close()
    with pytest.raises(RuntimeError, match="closed"):
        cm.initiate({"p": torch.ones(2)}, lambda h: None)


def test_committer_reuses_two_buffer_sets():
    """The host trees alternate between two sets (pinned on the card; on
    the CPU each commit clones, and the spare is the commit before the
    published one)."""
    cm = AsyncCommitter()
    try:
        got = []
        for i in range(3):
            cm.initiate({"p": torch.full((4,), float(i))}, got.append)
            cm.drain()
        assert [float(h["p"][0]) for h in got] == [0.0, 1.0, 2.0]
        assert cm._current is got[2] and cm._spare is got[1]
    finally:
        cm.close()


def test_snapshot_matches_the_sync_path_and_keeps_structure():
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "nested": (torch.ones(2, 2, dtype=torch.bfloat16),
                       [torch.tensor(7), 2.5]), "none": None}
    ps = SN.dispatch(tree)
    host = ps.join()
    assert ps.nbytes == 48 + 8 + 8
    assert host["none"] is None and host["nested"][1][1] == 2.5
    assert torch.equal(host["w"], tree["w"])
    assert host["w"].data_ptr() != tree["w"].data_ptr()
    tree["w"].add_(1)                            # the host copy stands
    assert float(host["w"][0, 0]) == 0.0
