"""The pipeline and the MoE-GPT steps on the card (marker ``cuda``; skips
without one).

Two gloo ranks share the card.  Each trains a small RoPE + SwiGLU + GQA
model (head_dim 64, as the flash kernels take) one SGD step at a time,
on the card, where every stage and every layer attends through the
flash kernels K1-K4, and on the CPU (the plain version), from the same
weights and batch.  In f32 the losses and each tensor's update must
agree to f32's summation order, and the kernels must have launched
exactly as the schedule issues them: the pipeline (pp 2, two virtual
stages, 2 microbatches) a rank's layers x microbatches each; the
MoE-GPT at (dp, ep) = (1, 2) a layer each.  The pipeline also runs in
bf16 on the card (``compute_dtype``, over the f32 masters), held to the
CPU's f32 run within chip_smoke.py's bf16 limits: it has no routing,
so its error stays at bf16's rounding.  The MoE-GPT is held in f32
only: in bf16 a token whose two largest router probabilities nearly tie
can change expert between the card and the CPU, which moves that
expert's gradient by the token's share (0.21 of one bank's update at
this size on the H100); chip_smoke.py's moe_gpt_470m holds its bf16
path against one process on the card.  Imports no JAX.
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
# each tensor's update on the card against the CPU's, ||d - d_ref|| /
# ||d_ref||: f32 products and the f32 flash kernels differ in summation
# order only
GRAD_TOL = 1e-3
# the bf16 pipeline on the card against the CPU's f32 run: chip_smoke.py's
# PAR_GRAD_TOL and PAR_LOSS_TOL
BF16_GRAD_TOL = 0.15
BF16_LOSS_TOL = 2e-2

WORKER = textwrap.dedent("""
    import dataclasses
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.models import gpt as G
    from kungfu_tpu_torch.ops import flash_attention as FA
    from kungfu_tpu_torch.parallel import moe_gpt as MG
    from kungfu_tpu_torch.parallel import pipeline as PP
    from kungfu_tpu_torch.utils.device import full_fp32_matmuls
    from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.cuda.set_device(0)
    full_fp32_matmuls()
    init_process_group_file(f"{tmp}/store", rank, world, "gloo",
                            timeout_s=120)
    pp_mesh = PP.mesh_dp_pp(1, 2, timeout_s=120)
    ep_mesh = MG.mesh_dp_ep(1, 2, timeout_s=120)

    gpt = G.GPTConfig(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
                      n_layers=4, d_ff=512, max_seq=128, rope=True,
                      mlp="swiglu", dtype=torch.float32)

    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, 256, (2, 129)))
    res = {}
    for dev, kind, cd in (("cuda", "pp", None), ("cuda", "moe", None),
                          ("cuda", "pp_bf16", torch.bfloat16),
                          ("cpu", "pp", None), ("cpu", "moe", None)):
        if kind != "moe":
            cfg = (gpt if cd is None
                   else dataclasses.replace(gpt, dtype=torch.bfloat16))
            params = PP.init_gpt_pp(cfg, pp_mesh, seed=0, device="cpu",
                                    virtual_stages=2)
        else:
            cfg = MG.MoEGPTConfig(gpt=gpt, n_experts=4,
                                  capacity_factor=8.0, aux_weight=0.0)
            params = MG.init_moe_gpt(cfg, ep_mesh, seed=0, device="cpu")
        params = tree_map(lambda t: t.to(dev), params)
        tag = f"{kind}/{dev}"
        for i, p in enumerate(tree_leaves(params)):
            res[f"{tag}/q{i}"] = p.detach().float().cpu().numpy().copy()
        opt = torch.optim.SGD(tree_leaves(params), lr=0.1)
        if kind != "moe":
            step = PP.make_gpt_pp_train_step(
                cfg, opt, pp_mesh, params, n_micro=2, virtual_stages=2,
                compute_dtype=cd)
        else:
            step = MG.make_train_step(cfg, opt, ep_mesh, params)
        for name in FA.launches:
            FA.launches[name] = 0
        t = toks.to(dev)
        loss = float(step(t[:, :-1], t[:, 1:]))
        res[f"{tag}/loss"] = np.array(loss)
        res[f"{tag}/launches"] = np.array(
            [FA.launches[n] for n in ("fa_fwd", "fa_delta",
                                      "fa_bwd_dq", "fa_bwd_dkv")])
        for i, p in enumerate(tree_leaves(params)):
            res[f"{tag}/p{i}"] = p.detach().float().cpu().numpy()
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_pipeline_and_moe_gpt_on_the_card_match_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = 2
    i, code = launch(
        [[sys.executable, "-c", WORKER, str(r), str(world), str(tmp_path)]
         for r in range(world)],
        dict(os.environ, PYTHONPATH=str(REPO)), REPO, 300, tmp_path)
    assert i is None, (code, (tmp_path / f"{i}.log").read_text())
    # pipeline: a rank holds 2 of the 4 layers, 2 microbatches each;
    # MoE-GPT: 4 layers over one row a rank
    # (the card's run, the CPU's run it is held to, loss rtol or atol,
    # each update's limit)
    cases = (("pp", "pp", dict(rtol=1e-4), GRAD_TOL),
             ("moe", "moe", dict(rtol=1e-4), GRAD_TOL),
             ("pp_bf16", "pp", dict(rtol=0, atol=BF16_LOSS_TOL),
              BF16_GRAD_TOL))
    for r in range(world):
        res = np.load(tmp_path / f"out{r}.npz")
        for kind, ref_kind, loss_tol, grad_tol in cases:
            assert list(res[f"{kind}/cuda/launches"]) == [4, 4, 4, 4]
            assert list(res[f"{ref_kind}/cpu/launches"]) == [0, 0, 0, 0]
            np.testing.assert_allclose(res[f"{kind}/cuda/loss"],
                                       res[f"{ref_kind}/cpu/loss"],
                                       **loss_tol)
            # each tensor's update (the SGD step's gradient x lr)
            n = sum(1 for k in res if k.startswith(f"{ref_kind}/cpu/p"))
            for j in range(n):
                got = res[f"{kind}/cuda/p{j}"] - res[f"{kind}/cuda/q{j}"]
                ref = (res[f"{ref_kind}/cpu/p{j}"]
                       - res[f"{ref_kind}/cpu/q{j}"])
                err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                      1e-30)
                assert err < grad_tol, (kind, j, err)
