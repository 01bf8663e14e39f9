"""Sharded elasticity on the card (marker ``cuda``; skips without one).

Two gloo ranks of ``ShardedElasticTrainer`` share the card under the
port's config server and watcher, their ZeRO-3 chunks and AdamW moments
on CUDA tensors; rank 1 is killed inside its gradient reduce-scatter of
step 3.  The survivor re-shards the commit of step 2 from its own block
and the ring replica: its chunks on the card equal those two blocks bit
for bit, its device memory after the re-shard is its state and at most
half a layer more (beyond the inputs and cuBLAS's workspaces, made
before the trainer), and it trains on to step 4 alone.  Imports no JAX.
"""
import json
import os
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WIDTH, LAYERS = 256, 4
LAYER_BYTES = WIDTH * WIDTH * 4

WORKER = textwrap.dedent("""
    import json, os, signal, sys, threading, time
    import torch
    from kungfu_tpu_torch.elastic import sharded as SH
    from kungfu_tpu_torch.launcher import env as E
    from kungfu_tpu_torch.parallel import fsdp as FS
    from kungfu_tpu_torch.utils.device import resolve_device

    out, width, layers = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    we = E.install(E.parse(sys.argv[4:]))
    rank0 = we.rank()
    dev = resolve_device("cuda")
    torch.cuda.set_device(0)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(8, width, generator=g).to(dev)
    y = torch.randn(8, 8, generator=g).to(dev)

    def tree(make):
        return {"layers": [{"w": make(width, width)} for _ in range(layers)],
                "head": make(width, 8)}
    if rank0 == 0:
        params = tree(lambda *s: torch.randn(*s, generator=g) * 0.05)
    else:
        params = tree(lambda *s: torch.empty(*s, device="meta"))

    def loss_fn(p, b):
        h = b[0]
        for lay in p["layers"]:
            h = torch.tanh(h @ lay["w"])
        return ((h @ p["head"] - b[1]) ** 2).mean()

    tr, held2, rec = None, {}, {"builds": []}
    real_sync, real_build = FS.fsdp_grad_sync, SH.ShardedElasticTrainer._build

    def sync_then_die(gflat, group=None):
        if rank0 == 1 and tr.step_count == 2:
            threading.Thread(target=real_sync, args=(gflat, group),
                             daemon=True).start()
            time.sleep(0.05)
            os.kill(os.getpid(), signal.SIGKILL)
        return real_sync(gflat, group)
    FS.fsdp_grad_sync = sync_then_die

    def build(self):
        M = self._synced["M"]
        real_build(self)
        torch.cuda.synchronize()
        vecs = self._vectors()
        rec["builds"].append({
            "M": M, "n": self.n, "mem": torch.cuda.memory_allocated() - base,
            "state": sum(v.numel() * v.element_size() for v in vecs.values()),
            "on_card": all(v.is_cuda for v in vecs.values())})
        if M == 2:
            rec["same"] = all(torch.equal(
                v.cpu(), torch.cat([held2[0][k], held2[1][k]])[:v.shape[0]])
                for k, v in vecs.items())
            rec["names"] = sorted(vecs)
    SH.ShardedElasticTrainer._build = build
    # cuBLAS's workspaces (this thread's and the autograd thread's) stay
    # once made: made here, they are not counted against the trainer
    w = torch.ones(64, 64, device=dev, requires_grad=True)
    (w @ w).sum().backward()
    del w
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tr = SH.ShardedElasticTrainer(
        loss_fn, lambda leaves, n: torch.optim.AdamW(leaves, lr=0.01),
        params, device=dev, collective_timeout_s=60.0)
    del params
    while tr.step_count < 4:
        tr.step((x, y))
        if tr.step_count == 2 and not held2:
            held2.update({r: {k: v.clone() for k, v in b.items()}
                          for r, b in tr._held[2].items()})
    rec.update(n=tr.n, restored=tr.recoveries[0]["restored"],
               state_bytes=tr.local_state_bytes())
    json.dump(rec, open(os.path.join(out, f"r{rank0}.json"), "w"))
    tr.shutdown()
""")


@pytest.mark.cuda
def test_a_kill_reshards_onto_the_survivor_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kungfu_tpu_torch.elastic import ConfigServer
    from kungfu_tpu_torch.launcher import env as E
    from kungfu_tpu_torch.launcher.watch import watch_run
    from kungfu_tpu_torch.plan import Cluster, HostList
    srv = ConfigServer().start()
    exclusions = []
    try:
        srv.put_cluster(Cluster.from_hostlist(HostList.parse("127.0.0.1:2"),
                                              2))
        exits = watch_run(
            srv, lambda r, c, v: [sys.executable, "-c", WORKER,
                                  str(tmp_path), str(WIDTH), str(LAYERS),
                                  *E.worker_argv(r, c.workers, v, srv.url,
                                                 str(tmp_path / "rdzv"))],
            str(tmp_path), env=dict(os.environ, PYTHONPATH=str(REPO)),
            cwd=str(REPO), timeout=240, exclusions=exclusions)
    finally:
        srv.stop()
    assert exits["127.0.0.1_31101_v1"] == -9 and len(exclusions) == 1
    got = json.loads((tmp_path / "r0.json").read_text())
    assert got["n"] == 1 and got["restored"] == [16, 2]
    assert got["same"] and got["names"] == ["exp_avg", "exp_avg_sq", "p"]
    for b in got["builds"]:
        assert b["on_card"] and b["mem"] <= b["state"] + LAYER_BYTES // 2, b
    assert [(b["M"], b["n"]) for b in got["builds"]] == [(None, 2), (2, 1)]
    assert got["state_bytes"] == got["builds"][-1]["state"]
