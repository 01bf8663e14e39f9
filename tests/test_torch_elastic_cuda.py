"""The elastic data plane on the card (marker ``cuda``; skips without one).

NCCL refuses two ranks on one card, so NCCL's re-formation is checked at
a world of one: versions 0, 1 and 2, each at a fresh FileStore, with an
all-reduce and a tree broadcast (CUDA leaves, a CPU leaf, a plain value)
at each.  The multi-rank resize runs over gloo on CUDA tensors: rank 0
trains Adam alone, rank 1 joins at version 1 and receives the
parameters and moments (the CUDA buffers staged through the host), and
after one more step both hold them bit for bit equal.  K2 takes a
microbatch of one sequence whose batch dimension carries stride 1 (the
elastic phase's cotangent) and agrees with its plain version.

Failure recovery: an NCCL group of one aborted and formed again; a commit
followed at once by an in-place AdamW step publishes the state as it was
before the step, bit for bit (the step waits on the commit's copies); and
gloo ranks on CUDA tensors under the port's watcher, one killed inside
its gradient all-reduce: two, the survivor restoring its pinned commit
bit for bit, and four, where a survivor whose last publish was dropped
receives rank 0's commit over a subgroup.  Imports no JAX.
"""
import os
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from kungfu_tpu_torch.examples.ranks import launch

REPO = Path(__file__).resolve().parents[1]
PEERS = ["127.0.0.1:31100"]


@pytest.mark.cuda
def test_nccl_reinit_at_world_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed as D
    torch.cuda.set_device(0)
    tree = {"w": torch.arange(6.0, device="cuda").reshape(2, 3),
            "b": [torch.ones(3, dtype=torch.bfloat16, device="cuda"), 5],
            "step": torch.tensor(3.0)}
    try:
        for v in range(3):
            if v == 0:
                D.initialize(PEERS, 0, 0, str(tmp_path), "nccl")
            else:
                assert D.reinit(PEERS, 0, v, str(tmp_path), "nccl")
            assert D.version() == v and dist.get_backend() == "nccl"
            x = torch.full((256,), float(v + 1), device="cuda")
            dist.all_reduce(x)
            assert bool((x == v + 1).all())
            got = D.broadcast_tree(tree)
            assert got["b"][1] == 5 and torch.equal(got["w"], tree["w"])
    finally:
        D.shutdown()
    assert not D.is_initialized()


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from kungfu_tpu_torch.elastic import ElasticTrainer
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.plan import PeerID, PeerList
    from kungfu_tpu_torch.utils.device import resolve_device

    rank, tmp = int(sys.argv[1]), sys.argv[2]
    dev = resolve_device("cuda")
    torch.cuda.set_device(0)
    peers = PeerList(PeerID("127.0.0.1", 31100 + i, i) for i in range(2))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 4).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(8, 2).astype(np.float32)).to(dev)
    params = {"w": torch.full((4, 2), float(rank), device=dev)}
    tr = ElasticTrainer(
        lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean(),
        lambda leaves, n: synchronous_sgd(torch.optim.Adam(leaves, lr=0.1)),
        params, peers, rank, init_size=rank + 1, version=rank,
        rendezvous=tmp + "/rdzv", backend="gloo")
    if rank == 0:
        for _ in range(2):
            tr.step((x, y))
        tr.resize(2)
    got = tr.optimizer.state[params["w"]]
    res = {"w_sync": params["w"].cpu().numpy(),
           "m_sync": got["exp_avg"].cpu().numpy(),
           "on_card": np.asarray(got["exp_avg"].is_cuda)}
    tr.step((x, y))
    res["w_end"] = params["w"].cpu().numpy()
    res["bytes"] = np.asarray(tr.last_sync_bytes)
    np.savez(f"{tmp}/out{rank}.npz", **res)
    tr.shutdown()
""")


@pytest.mark.cuda
def test_gloo_grow_on_cuda_tensors(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    i, code = launch(
        [[sys.executable, "-c", WORKER, str(r), str(tmp_path)]
         for r in range(2)], dict(os.environ, PYTHONPATH=str(REPO)), REPO,
        240, tmp_path)
    assert i is None, (code, (tmp_path / f"{i}.log").read_text())
    r0, r1 = (np.load(tmp_path / f"out{r}.npz") for r in range(2))
    for key in ("w_sync", "m_sync", "w_end"):
        np.testing.assert_array_equal(r0[key], r1[key])
    assert bool(r1["on_card"]) and np.abs(r0["m_sync"]).max() > 0
    assert not np.allclose(r0["w_end"], 0.0)
    # w, both moments and Adam's step: 4 x 2 f32 each, and a 0-d f32
    assert int(r1["bytes"]) == 3 * 32 + 4


@pytest.mark.cuda
def test_flash_delta_takes_a_one_sequence_batch_of_any_batch_stride():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kungfu_tpu_torch.ops import flash_attention as FA
    g = torch.Generator(device="cuda").manual_seed(0)
    out, dout = (torch.randn(1, 256, 4, 64, generator=g, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
    dout = dout.as_strided(dout.shape, (1, 256, 64, 1))
    got = FA.flash_delta(out, dout)
    want = FA.flash_delta(out.cpu(), dout.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_nccl_abort_then_reform_at_world_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed as D
    torch.cuda.set_device(0)
    try:
        D.initialize(PEERS, 0, 0, str(tmp_path), "nccl", timeout_s=60.0)
        x = torch.ones(256, device="cuda")
        dist.all_reduce(x)
        D.abort()
        assert not D.is_initialized() and not dist.is_initialized()
        D.initialize(PEERS, 0, 1, str(tmp_path), "nccl", timeout_s=60.0)
        x = torch.full((256,), 2.0, device="cuda")
        dist.all_reduce(x)
        assert D.version() == 1 and bool((x == 2.0).all())
    finally:
        D.shutdown()


@pytest.mark.cuda
def test_a_commit_is_not_torn_by_the_next_in_place_step():
    """The copies of a commit run on a side stream; the AdamW step right
    after it writes the same tensors in place on the main stream, after
    waiting on the copies (the trainer's step pre-hook).  Each published
    host tree equals a synchronous snapshot taken before the step, and
    the third commit reuses the first one's pinned buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kungfu_tpu_torch.elastic.snapshot import AsyncCommitter, snapshot
    from kungfu_tpu_torch.utils.tree import tree_map
    torch.cuda.set_device(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    p = torch.nn.Parameter(torch.randn(64 << 20, device="cuda",
                                       generator=g))          # 256 MB
    opt = torch.optim.AdamW([p], lr=0.1)
    cm = AsyncCommitter()
    opt.register_step_pre_hook(lambda o, args, kwargs: cm.fence())
    got, want, ptrs = [], [], []

    def publish(host):
        # a later commit reuses these buffers: keep what they hold now
        ptrs.append((host["p"].data_ptr(), host["p"].is_pinned()))
        got.append(tree_map(lambda t: t.clone() if isinstance(
            t, torch.Tensor) else t, host))
    try:
        for _ in range(3):
            p.grad = torch.randn(p.shape, device="cuda", generator=g)
            opt.step()
            tree = {"p": p, "opt": opt.state_dict()}
            want.append(snapshot(tree))
            cm.initiate(tree, publish)
            p.grad = torch.randn(p.shape, device="cuda", generator=g)
            opt.step()                  # in place, at once
        cm.drain()
    finally:
        cm.close()
    for h, w in zip(got, want):
        assert torch.equal(h["p"], w["p"])
        st, ws = h["opt"]["state"][0], w["opt"]["state"][0]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st[key], ws[key]), key
    assert all(pinned for _, pinned in ptrs)
    assert ptrs[2][0] == ptrs[0][0] and ptrs[1][0] != ptrs[0][0]


RECOVER_WORKER = textwrap.dedent("""
    import json, os, signal, sys, threading, time
    import torch
    from kungfu_tpu_torch.elastic import DistributedElasticTrainer
    from kungfu_tpu_torch.elastic.snapshot import snapshot
    from kungfu_tpu_torch.launcher import env as E
    from kungfu_tpu_torch.optimizers import sync_sgd as SS
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.utils.device import resolve_device
    from kungfu_tpu_torch.utils.tree import tree_leaves

    out, victim, drop = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    we = E.install(E.parse(sys.argv[4:]))
    rank0 = we.rank()
    dev = resolve_device("cuda")
    torch.cuda.set_device(0)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(48, 256, device=dev, generator=g)  # 4, 3, 2 or 1 ranks
    y = torch.randn(48, 8, device=dev, generator=g)
    params = {"w": torch.full((256, 8), float(rank0), device=dev),
              "b": torch.zeros(8, device=dev)}
    tr = None
    real = SS.cross_replica_mean_gradients

    def mean_then_die(grads, group=None, fusion=False):
        if rank0 == victim and tr.step_count == 2:
            threading.Thread(target=real, args=(grads, group, fusion),
                             daemon=True).start()
            time.sleep(0.05)
            os.kill(os.getpid(), signal.SIGKILL)
        return real(grads, group, fusion)
    SS.cross_replica_mean_gradients = mean_then_die
    tr = DistributedElasticTrainer(
        lambda p, b: ((b[0] @ p["w"] + p["b"] - b[1]) ** 2).mean(),
        lambda leaves, n: synchronous_sgd(torch.optim.AdamW(leaves, lr=0.1)),
        params, backend="gloo", collective_timeout_s=60.0)
    real_publish = tr._publish

    def publish(host, devices, progress):
        # rank ``drop`` never publishes the commit of step 2: its commit
        # differs from rank 0's, which rank 0 then sends it
        if not (rank0 == drop and progress[1] == 2 and not tr.recoveries):
            real_publish(host, devices, progress)
    tr._publish = publish
    seen = {}
    real_restore = tr._restore_committed

    def restore():
        moved = real_restore()
        seen["restored"] = snapshot({"params": tr.params,
                                     "opt": tr.optimizer.state_dict()})
        seen["on_card"] = all(t.is_cuda for st in tr.optimizer.state.values()
                              for t in (st["exp_avg"], st["exp_avg_sq"]))
        seen["step_on_cpu"] = all(not st["step"].is_cuda
                                  for st in tr.optimizer.state.values())
        return moved
    tr._restore_committed = restore
    while tr.step_count < 4:
        tr.step((x, y))
        if tr.step_count == 2:
            tr._committer.drain()
            seen["commit2"] = snapshot({"params": tr.params,
                                        "opt": tr.optimizer.state_dict()})
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(seen["restored"]), tree_leaves(seen["commit2"]))
        if isinstance(a, torch.Tensor))
    json.dump({"same": same, "on_card": seen["on_card"], "n": tr.n,
               "step_on_cpu": seen["step_on_cpu"],
               "restored": tr.recoveries[0]["restored"],
               "bytes": tr.recoveries[0]["restore_bytes"]},
              open(os.path.join(out, f"r{rank0}.json"), "w"))
    tr.shutdown()
""")


def _recover_on_card(tmp_path, size: int, victim: int, drop: int):
    """Run RECOVER_WORKER on ``size`` gloo ranks sharing the card under
    the port's watcher; the survivors' records by first rank."""
    import json
    from kungfu_tpu_torch.elastic import ConfigServer
    from kungfu_tpu_torch.launcher import env as E
    from kungfu_tpu_torch.launcher.watch import watch_run
    from kungfu_tpu_torch.plan import Cluster, HostList
    srv = ConfigServer().start()
    exclusions = []
    try:
        srv.put_cluster(Cluster.from_hostlist(
            HostList.parse(f"127.0.0.1:{size}"), size))
        exits = watch_run(
            srv, lambda r, c, v: [sys.executable, "-c", RECOVER_WORKER,
                                  str(tmp_path), str(victim), str(drop),
                                  *E.worker_argv(
                                      r, c.workers, v, srv.url,
                                      str(tmp_path / "rdzv"))],
            str(tmp_path), env=dict(os.environ, PYTHONPATH=str(REPO)),
            cwd=str(REPO), timeout=240, exclusions=exclusions)
    finally:
        srv.stop()
    assert exits[f"127.0.0.1_{31100 + victim}_v1"] == -9
    assert len(exclusions) == 1
    return {r: json.loads((tmp_path / f"r{r}.json").read_text())
            for r in range(size) if r != victim}


@pytest.mark.cuda
def test_gloo_kill_on_cuda_tensors_restores_the_pinned_commit(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = _recover_on_card(tmp_path, 2, victim=1, drop=-1)[0]
    assert got["same"] and got["on_card"] and got["n"] == 1
    assert got["restored"] == [96, 2] and got["bytes"] == 0


@pytest.mark.cuda
def test_a_differing_survivor_receives_rank_0s_commit_on_the_card(tmp_path):
    """Four gloo ranks on CUDA tensors; rank 2 drops its publish of the
    commit of step 2 and rank 3 dies in step 3's all-reduce.  Rank 0
    sends rank 2 its pinned commit over a subgroup of the two; rank 2's
    moments land on the card, its Adam step counts on the CPU, and every
    survivor holds the state of step 2 bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = _recover_on_card(tmp_path, 4, victim=3, drop=2)
    for r in got.values():
        assert r["same"] and r["on_card"] and r["step_on_cpu"]
        assert r["n"] == 3 and r["restored"] == [96, 2]
    assert got[0]["bytes"] > 0 and got[2]["bytes"] == got[0]["bytes"]
    assert got[1]["bytes"] == 0
