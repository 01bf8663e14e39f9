"""MoE-GPT under expert parallelism, dp x ep (counterpart of
examples/moe_gpt_expert_parallel.py).

Every second transformer block routes its tokens to switch-MoE experts
sharded over the ep ranks (all-to-all dispatch, static capacity, the
load-balancing auxiliary loss).  One process per rank of the (dp, ep)
mesh; bf16 compute over f32 masters on the card (the flash kernels in
every layer), f32 on the CPU.

    python -m kungfu_tpu_torch.examples.moe_gpt_expert_parallel --device cpu
    python -m kungfu_tpu_torch.examples.moe_gpt_expert_parallel \
        --backend gloo

The second runs its 8 ranks on the card(s): more ranks than cards need
``--backend gloo`` (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.gpt import GPTConfig
from ..parallel import moe_gpt as MG
from ..utils.tree import tree_leaves
from . import ranks


def run(args, device) -> None:
    # head_dim 64, as the flash kernels take (JAX's example: d_model 128)
    cfg = MG.MoEGPTConfig(
        gpt=GPTConfig(vocab_size=512, d_model=512, n_heads=8, n_layers=4,
                      d_ff=1024, max_seq=256,
                      dtype=(torch.bfloat16 if device.type == "cuda"
                             else torch.float32)),
        n_experts=8, expert_every=2, capacity_factor=1.5)
    mesh = MG.mesh_dp_ep(args.dp, args.ep, timeout_s=args.timeout_s)
    params = MG.init_moe_gpt(cfg, mesh, seed=0, device=device)
    opt = torch.optim.AdamW(tree_leaves(params), lr=3e-4)
    step = MG.make_train_step(
        cfg, opt, mesh, params,
        compute_dtype=torch.bfloat16 if device.type == "cuda" else None)

    rng = np.random.RandomState(0)
    batch, seq = 16, 64         # batch split over dp x ep
    for i in range(args.steps):
        toks = torch.from_numpy(
            rng.randint(0, cfg.gpt.vocab_size, (batch, seq + 1))).to(device)
        loss = step(toks[:, :-1], toks[:, 1:])
        if args.rank == 0:
            print(f"step {i}: loss={float(loss):.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--ep", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--timeout-s", type=float, default=300.0,
                    help="a collective that does not complete fails the "
                         "run after this long")
    ranks.add_args(ap)
    argv = sys.argv[1:] if argv is None else argv
    args = ap.parse_args(argv)
    args.world = args.dp * args.ep
    return ranks.main(__spec__.name, args, argv, run)


if __name__ == "__main__":
    sys.exit(main())
