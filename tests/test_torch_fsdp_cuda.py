"""ZeRO-3 and ZeRO-1 on the card (marker ``cuda``; skips without one).

One process, a world of one: the default group is NCCL, so NCCL's
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` run under
``collectives._gather_tiled`` and ``_reduce_scatter_tiled``, and a gloo
group of the same rank runs the same three steps (``make_fsdp_step``,
``make_fsdp_scan_step``, ``make_zero1_step``) for comparison, f32 on
CUDA tensors.  Then the card form of tests/test_fsdp_scan.py:117, at
its 8 ranks (gloo, sharing the card): ``torch.cuda.max_memory_allocated``
above the step's start holds one layer's gathered copy in the scan step
and the full parameters in the monolithic one, and after ``init`` a rank
holds its chunks and no full copy.  Imports no JAX.
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
MEM_D, MEM_L = 1024, 16          # the memory case: 4.2 MB a layer
MEM_RANKS = 8

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.parallel import fsdp as FS

    tmp, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    D, L = int(sys.argv[4]), int(sys.argv[5])
    torch.cuda.set_device(0)
    init_process_group_file(f"{tmp}/store", rank, world,
                            "nccl" if world == 1 else "gloo", timeout_s=120)
    dev = torch.device("cuda", 0)

    def params_of(d, layers, seed=0):
        g = torch.Generator().manual_seed(seed)
        f = lambda *s: (torch.randn(*s, generator=g) * 0.1).to(dev)
        return {"embed": {"w_in": f(16, d)},
                "layers": {"w": f(layers, d, d),
                           "b": torch.zeros(layers, d, device=dev)},
                "head": {"w_out": f(d, 4)}}

    def embed(ep, b):
        return torch.tanh(b[0] @ ep["w_in"])

    def layer(lp, a):
        return a + torch.tanh(a @ lp["w"] + lp["b"])

    def head(hp, a, b):
        return ((a @ hp["w_out"] - b[1]) ** 2).mean()

    def flat_loss(p, b):
        a = embed(p["embed"], b)
        for i in range(p["layers"]["w"].shape[0]):
            a = layer({k: v[i] for k, v in p["layers"].items()}, a)
        return head(p["head"], a, b)

    def build(kind, group):
        opt = lambda ps: torch.optim.Adam(ps, lr=1e-2)
        if kind == "scan":
            return FS.make_fsdp_scan_step(embed, layer, head, opt, group)
        maker = FS.make_fsdp_step if kind == "flat" else FS.make_zero1_step
        return maker(flat_loss, opt, group)

    g = torch.Generator().manual_seed(1)
    batch = tuple(torch.randn(2 * world, n, generator=g).to(dev)
                  for n in (16, 4))
    res = {}
    groups = {}
    if world == 1:
        groups = {"nccl": None, "gloo": dist.new_group([0], backend="gloo")}
    for kind in ("flat", "scan", "zero1"):
        for name, group in groups.items():
            init, make = build(kind, group)
            state, opt, meta = init(params_of(64, 3))
            step = make(meta)
            res[f"{kind}/{name}/loss"] = np.array(
                [float(step(state, opt, batch)) for _ in range(3)])
            out = state if isinstance(state, dict) else {"flat": state}
            for k, v in out.items():
                res[f"{kind}/{name}/p/{k}"] = v.detach().cpu().numpy()
    for kind in ("scan", "flat") if world > 1 else ():
        init, make = build(kind, None)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        state, opt, meta = init(params_of(D, L))
        res[f"init/{kind}"] = np.array(
            [torch.cuda.memory_allocated() - base,
             sum(t.numel() * t.element_size()
                 for t in (state.values() if kind == "scan" else [state]))])
        step = make(meta)
        step(state, opt, batch)            # the optimizer's state exists
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(state, opt, batch)
        torch.cuda.synchronize()
        res[f"mem/{kind}"] = np.array(torch.cuda.max_memory_allocated()
                                      - base)
        del state, opt, meta, step
        torch.cuda.empty_cache()
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")


def _run(tmp, world):
    i, code = launch([[sys.executable, "-c", WORKER, str(tmp), str(r),
                       str(world), str(MEM_D), str(MEM_L)]
                      for r in range(world)],
                     dict(os.environ, PYTHONPATH=str(REPO)), REPO, 300, tmp)
    assert i is None, (code, (tmp / f"{i}.log").read_text())
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _run(tmp_path_factory.mktemp("fsdp_cuda"), 1)[0]


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _run(tmp_path_factory.mktemp("fsdp_cuda_mem"), MEM_RANKS)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "scan", "zero1"])
def test_nccl_world_of_one_matches_gloo(card, kind):
    np.testing.assert_allclose(card[f"{kind}/nccl/loss"],
                               card[f"{kind}/gloo/loss"], rtol=1e-6)
    for key in [k for k in card if k.startswith(f"{kind}/nccl/p/")]:
        np.testing.assert_allclose(card[key],
                                   card[key.replace("/nccl/", "/gloo/")],
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    assert card[f"{kind}/nccl/loss"][-1] < card[f"{kind}/nccl/loss"][0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["scan", "flat"])
def test_init_holds_only_the_shards(card_ranks, kind):
    """After ``init`` (the caller's tree gone) a rank's device memory
    holds its chunks and less than half a layer more: no full copy of
    the parameters outlives the call."""
    slack = 4 * (MEM_D * MEM_D + MEM_D) // 2
    for r, res in enumerate(card_ranks):
        held, shards = (int(x) for x in res[f"init/{kind}"])
        assert held <= shards + slack, (r, held, shards)


@pytest.mark.cuda
def test_scan_step_peak_is_one_layer_not_the_full_parameters(card_ranks):
    layer = 4 * (MEM_D * MEM_D + MEM_D)
    full = MEM_L * layer
    for r, res in enumerate(card_ranks):
        scan, flat = int(res["mem/scan"]), int(res["mem/flat"])
        assert flat > full, (r, flat, full)
        assert scan < flat / 2, (r, scan, flat)
        assert scan < full, (r, scan, full)
