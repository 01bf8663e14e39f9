"""Pipeline-parallel GPT training, dp x pp x tp (counterpart of
examples/gpt_pipeline.py).

The layer stack is split over the pipeline stages and microbatches flow
through a GPipe schedule; ``--virtual-stages v`` switches to the
Megatron-style interleaved schedule (each rank holds v layer chunks;
compute bubble 1 + (S-1)/(v*M) instead of 1 + (S-1)/M).  One process per
rank of the (dp, pp, tp) mesh; bf16 compute over f32 masters on the
card (the flash kernels in every stage), f32 on the CPU.

    python -m kungfu_tpu_torch.examples.gpt_pipeline --device cpu
    python -m kungfu_tpu_torch.examples.gpt_pipeline --backend gloo \
        --virtual-stages 2

The second runs its 8 ranks on the card(s): more ranks than cards need
``--backend gloo`` (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.gpt import GPTConfig
from ..parallel import pipeline as PP
from ..utils.tree import tree_leaves
from . import ranks


def run(args, device) -> None:
    # head_dim 64, as the flash kernels take (JAX's example: d_model 128)
    cfg = GPTConfig(vocab_size=512, d_model=512, n_heads=8, n_layers=8,
                    d_ff=1024, max_seq=256,
                    dtype=(torch.bfloat16 if device.type == "cuda"
                           else torch.float32))
    mesh = PP.mesh_dp_pp_tp(args.dp, args.pp, args.tp,
                            timeout_s=args.timeout_s)
    params = PP.init_gpt_pp(cfg, mesh, seed=0, device=device,
                            virtual_stages=args.virtual_stages)
    opt = torch.optim.AdamW(tree_leaves(params), lr=3e-4)
    step = PP.make_gpt_pp_train_step(
        cfg, opt, mesh, params, n_micro=4,
        virtual_stages=args.virtual_stages,
        compute_dtype=torch.bfloat16 if device.type == "cuda" else None)

    rng = np.random.RandomState(0)
    batch, seq = 8, 64          # batch split over dp, then 4 microbatches
    for i in range(args.steps):
        toks = torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (batch, seq + 1))).to(device)
        loss = step(toks[:, :-1], toks[:, 1:])
        if args.rank == 0:
            print(f"step {i}: loss={float(loss):.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--virtual-stages", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--timeout-s", type=float, default=300.0,
                    help="a collective that does not complete fails the "
                         "run after this long")
    ranks.add_args(ap)
    argv = sys.argv[1:] if argv is None else argv
    args = ap.parse_args(argv)
    args.world = args.dp * args.pp * args.tp
    return ranks.main(__spec__.name, args, argv, run)


if __name__ == "__main__":
    sys.exit(main())
