"""3D-parallel GPT training, dp x sp x tp in one step (counterpart of
examples/gpt_3d_parallel.py).

Data parallelism, ring-attention sequence parallelism and Megatron-style
tensor parallelism with a vocab-sharded parallel cross-entropy, one
process per rank of the (dp, sp, tp) mesh.  The LLaMA-style model: RoPE,
grouped-query attention, SwiGLU; bf16 compute over f32 masters on the
card, f32 on the CPU.

    python -m kungfu_tpu_torch.examples.gpt_3d_parallel --device cpu
    python -m kungfu_tpu_torch.examples.gpt_3d_parallel --backend gloo

The second runs its 8 ranks on the card(s): more ranks than cards need
``--backend gloo`` (NCCL refuses two ranks on one device).  ``--attn
auto`` is ring-flash attention on the card (the flash kernels on every
chunk) and dense ring attention on the CPU.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.gpt import GPTConfig
from ..parallel import threed as T3
from ..utils.tree import tree_leaves
from . import ranks


def run(args, device) -> None:
    # head_dim 64, as the flash kernels take (JAX's example: d_model 128)
    cfg = GPTConfig(vocab_size=512, d_model=512, n_heads=8, n_layers=4,
                    d_ff=1024, max_seq=256, rope=True, n_kv_heads=4,
                    mlp="swiglu",
                    dtype=(torch.bfloat16 if device.type == "cuda"
                           else torch.float32))
    mesh = T3.mesh_3d(args.dp, args.sp, args.tp,
                      timeout_s=args.timeout_s)
    params = T3.init_gpt(cfg, mesh, seed=0, device=device)
    opt = torch.optim.AdamW(tree_leaves(params), lr=3e-4)
    step = T3.make_gpt_train_step(
        cfg, opt, mesh, params, attn=args.attn,
        compute_dtype=torch.bfloat16 if device.type == "cuda" else None)

    rng = np.random.RandomState(0)
    batch, seq = 8, 64          # batch sharded over dp, sequence over sp
    for i in range(args.steps):
        toks = torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (batch, seq + 1))).to(device)
        loss = step(toks[:, :-1], toks[:, 1:])
        if args.rank == 0:
            print(f"step {i}: loss={float(loss):.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--sp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--attn", default="auto",
                    choices=("auto", "ring", "ring_flash", "ulysses"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--timeout-s", type=float, default=300.0,
                    help="a collective that does not complete fails the "
                         "run after this long")
    ranks.add_args(ap)
    argv = sys.argv[1:] if argv is None else argv
    args = ap.parse_args(argv)
    args.world = args.dp * args.sp * args.tp
    return ranks.main(__spec__.name, args, argv, run)


if __name__ == "__main__":
    sys.exit(main())
