"""The ring exchange and SMA on CUDA tensors across three gloo processes,
against the same on CPU tensors (marker ``cuda``; skips without a card).

Gloo's point-to-point takes CPU tensors only, so ``ring_exchange`` stages
a CUDA buffer through the host; its all-reduce takes CUDA tensors.  The
exchange must be exact; SMA's parameters after 3 steps agree within
1e-6 (f32; TF32 is off, and the CPU and the card sum the quadratic's
gradients in other orders).  Imports no JAX.
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

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.optimizers import synchronous_averaging
    from kungfu_tpu_torch.training import build_train_step
    from kungfu_tpu_torch.utils.device import resolve_device

    rank, tmp = int(sys.argv[1]), sys.argv[2]
    cuda = resolve_device("cuda")
    init_process_group_file(tmp + "/store", rank, 3, "gloo")
    res = {}
    for dev in ("cpu", "cuda"):
        tree = [torch.arange(5., device=dev) + 10 * rank,
                torch.tensor([rank], device=dev)]
        for s in (1, 2):
            got = C.ring_exchange(tree, None, s, 3)
            assert all(t.device.type == dev for t in got)
            res[f"ring{s}_{dev}"] = np.concatenate(
                [t.cpu().numpy().astype(np.float64) for t in got])
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(96, 4).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.randn(96, 1).astype(np.float32)).to(dev)
        params = {"w": torch.full((4, 1), float(rank), device=dev,
                                  requires_grad=True)}
        opt = synchronous_averaging(torch.optim.SGD([params["w"]], lr=0.05),
                                    alpha=0.5)
        step = build_train_step(
            lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean(), opt, params)
        for _ in range(3):
            step((x, y))
        res[f"sma_{dev}"] = params["w"].detach().cpu().numpy()
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_ring_exchange_and_sma_on_cuda_match_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    i, code = launch(
        [[sys.executable, "-c", WORKER, str(r), str(tmp_path)]
         for r in range(3)], dict(os.environ, PYTHONPATH=str(REPO)), REPO,
        240, tmp_path)
    assert i is None, (code, (tmp_path / f"{i}.log").read_text())
    for r in range(3):
        out = np.load(tmp_path / f"out{r}.npz")
        src = (r - 1) % 3
        np.testing.assert_array_equal(
            out["ring1_cuda"], np.r_[np.arange(5.) + 10 * src, src])
        for s in (1, 2):
            np.testing.assert_array_equal(out[f"ring{s}_cuda"],
                                          out[f"ring{s}_cpu"])
        np.testing.assert_allclose(out["sma_cuda"], out["sma_cpu"],
                                   rtol=0, atol=1e-6)
        assert not np.allclose(out["sma_cuda"], r)     # it trained
