"""Ring-flash attention on the card (marker ``cuda``; skips without one).

Two gloo ranks share the card.  Each runs ``ring_flash_attention`` over
its half of the sequence through the flash kernels K1-K4 (bf16 CUDA
tensors, staged through the host for the rotations) and the same
function on the plain flash version (the same values as f32 CPU
tensors), forward and gradients, causal and not, GQA with compact KV
heads.  Under ``causal`` rank r runs the kernels on r + 1 chunks (the
diagonal and the past); a future chunk runs none.  Also: the 3D example
trains on the card with its defaults.  Imports no JAX.
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
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.ops import flash_attention as FA
    from kungfu_tpu_torch.parallel import ring_flash_attention

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.cuda.set_device(0)
    init_process_group_file(f"{tmp}/store", rank, world, "gloo",
                            timeout_s=120)
    B, T, H, KVH, D = 1, 512, 8, 2, 64
    res = {}
    for causal in (False, True):
        g = torch.Generator().manual_seed(int(causal))
        q, do = (torch.randn(B, world * T, H, D, generator=g)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, world * T, KVH, D, generator=g)
                .to(torch.bfloat16) for _ in range(2))
        mine = lambda t: t[:, rank * T:(rank + 1) * T].contiguous()
        for path, dev, dt in (("kernel", "cuda", torch.bfloat16),
                              ("plain", "cpu", torch.float32)):
            qq, kk, vv = (mine(t).to(dev, dt).requires_grad_()
                          for t in (q, k, v))
            for name in FA.launches:
                FA.launches[name] = 0
            out = ring_flash_attention(qq, kk, vv, dist.group.WORLD,
                                       causal=causal, kv_groups=H // KVH)
            (out.float() * mine(do).to(dev).float()).sum().backward()
            torch.cuda.synchronize()
            tag = f"{int(causal)}/{path}"
            for key, t in (("out", out), ("dq", qq.grad), ("dk", kk.grad),
                           ("dv", vv.grad)):
                res[f"{tag}/{key}"] = t.detach().float().cpu().numpy()
            res[f"{tag}/launches"] = np.array(
                [FA.launches[n] for n in ("fa_fwd", "fa_delta",
                                          "fa_bwd_dq", "fa_bwd_dkv")])
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_ring_flash_kernels_match_plain_on_two_ranks(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = 2
    i, code = launch(
        [[sys.executable, "-c", WORKER, str(r), str(world), str(tmp_path)]
         for r in range(world)],
        dict(os.environ, PYTHONPATH=str(REPO)), REPO, 300, tmp_path)
    assert i is None, (code, (tmp_path / f"{i}.log").read_text())
    for r in range(world):
        res = np.load(tmp_path / f"out{r}.npz")
        for causal in (0, 1):
            for key in ("out", "dq", "dk", "dv"):
                got = res[f"{causal}/kernel/{key}"]
                want = res[f"{causal}/plain/{key}"]
                # bf16 inputs, kernels' p and ds rounded to bf16 before
                # the products: chip_smoke.FLASH_TOL's bf16 "max" limit
                err = np.abs(got - want).max() / max(np.abs(want).max(), 1)
                assert err <= 2e-2, (r, causal, key, err)
            chunks = r + 1 if causal else world
            np.testing.assert_array_equal(
                res[f"{causal}/kernel/launches"], [chunks] * 4)
            np.testing.assert_array_equal(
                res[f"{causal}/plain/launches"], [0] * 4)


@pytest.mark.cuda
def test_example_trains_on_the_card():
    """``python -m kungfu_tpu_torch.examples.gpt_3d_parallel --backend
    gloo``: its 8 ranks (2 x 2 x 2) share the card, ring-flash attention
    on the flash kernels; the loss falls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.examples.gpt_3d_parallel",
         "--backend", "gloo", "--steps", "3"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    losses = [float(line.split("loss=")[1]) for line in r.stdout.splitlines()
              if "loss=" in line]
    assert len(losses) == 3 and np.all(np.isfinite(losses)), r.stdout
    assert losses[-1] < losses[0], losses
