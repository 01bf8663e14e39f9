"""ZeRO-sharded data parallelism: ZeRO-3 (fsdp) beside ZeRO-1
(counterpart of examples/fsdp_zero.py).

Both shard the optimizer state 1/n a rank; ZeRO-3 also shards the
parameters themselves (all-gather before compute, reduce-scatter after).
40 Adam steps of a two-layer MLP each, printing the loss curve and the
layout.

    python -m kungfu_tpu_torch.examples.fsdp_zero --world 2 --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..parallel import make_fsdp_step, make_zero1_step
from . import ranks


def run(args, device) -> None:
    n = args.world
    rng = np.random.RandomState(0)
    t = lambda *s, scale=1.0: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(device)
    params = {"w1": t(64, 128, scale=0.1), "w2": t(128, 8, scale=0.1)}
    x, y = t(8 * n, 64), t(8 * n, 8)

    def loss_fn(p, batch):
        bx, by = batch
        h = torch.relu(bx @ p["w1"])
        return ((h @ p["w2"] - by) ** 2).mean()

    for name, maker in (("ZeRO-3 (fsdp)", make_fsdp_step),
                        ("ZeRO-1", make_zero1_step)):
        init, make_step = maker(loss_fn,
                                lambda ps: torch.optim.Adam(ps, lr=1e-2))
        state, opt, meta = init(params)
        step = make_step(meta)
        losses = [float(step(state, opt, (x, y))) for _ in range(args.steps)]
        layout = ("sharded" if maker is make_fsdp_step else "replicated")
        if args.rank == 0:
            print(f"{name:14s} loss {losses[0]:.6f} -> {losses[-1]:.6f}  "
                  f"(params {layout} {n}-way: {tuple(state.shape)} a rank, "
                  f"opt state sharded {n}-way)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ranks.add_args(ap)
    ap.add_argument("--steps", type=int, default=40)
    argv = sys.argv[1:] if argv is None else argv
    return ranks.main(__spec__.name, ap.parse_args(argv), argv, run)


if __name__ == "__main__":
    sys.exit(main())
