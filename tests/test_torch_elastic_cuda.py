"""The elastic data plane on the card (marker ``cuda``; skips without one).

NCCL refuses two ranks on one card, so NCCL's re-formation is checked at
a world of one: versions 0, 1 and 2, each at a fresh FileStore, with an
all-reduce and a tree broadcast (CUDA leaves, a CPU leaf, a plain value)
at each.  The multi-rank resize runs over gloo on CUDA tensors: rank 0
trains Adam alone, rank 1 joins at version 1 and receives the
parameters and moments (the CUDA buffers staged through the host), and
after one more step both hold them bit for bit equal.  K2 takes a
microbatch of one sequence whose batch dimension carries stride 1 (the
elastic phase's cotangent) and agrees with its plain version.  Imports
no JAX.
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
