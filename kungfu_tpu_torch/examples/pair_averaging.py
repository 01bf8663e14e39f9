"""AD-PSGD pair averaging (counterpart of examples/pair_averaging.py):
each rank trains on its own batches and mixes its parameters with a
scheduled partner every step.

    python -m kungfu_tpu_torch.examples.pair_averaging --world 4 --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..optimizers import pair_averaging
from ..training import build_train_step, lane_mean
from . import ranks


def run(args, device) -> None:
    n = args.world
    params = {"w": torch.zeros(8, 1, device=device, requires_grad=True)}
    rng = np.random.RandomState(0)
    w_true = rng.randn(8, 1).astype(np.float32)

    def loss_fn(p, batch):
        x, y = batch
        return ((x @ p["w"] - y) ** 2).mean()

    opt = pair_averaging(torch.optim.SGD([params["w"]], lr=0.05), n=n)
    step = build_train_step(loss_fn, opt, params)
    for i in range(args.steps):
        # every rank sees a different block of the batch: gossip keeps the
        # replicas converging
        x = rng.randn(16 * n, 8).astype(np.float32)
        y = x @ w_true + 0.01 * rng.randn(16 * n, 1).astype(np.float32)
        loss = step((torch.from_numpy(x).to(device),
                     torch.from_numpy(y).to(device)))
        if i % 50 == 0 and args.rank == 0:
            print(f"step {i:3d} loss={float(loss):.5f}", flush=True)
    err = float((lane_mean(params)["w"].detach().cpu()
                 - torch.from_numpy(w_true)).abs().max())
    if args.rank == 0:
        print(f"max |w - w_true| over averaged replicas: {err:.4f}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ranks.add_args(ap)
    argv = sys.argv[1:] if argv is None else argv
    return ranks.main(__spec__.name, ap.parse_args(argv), argv, run)


if __name__ == "__main__":
    sys.exit(main())
