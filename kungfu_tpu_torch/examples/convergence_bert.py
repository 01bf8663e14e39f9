"""BERT-tiny MLM convergence under SMA + gradient-noise-scale monitoring
(counterpart of examples/convergence_bert.py).

The convergence companion to ``bert_sma_gns``: it trains on learnable
synthetic text (a fixed bank of template sentences, randomly masked), so
the loss curve is a real convergence signal, recorded from start to end
against ``--target``.  Every rank draws the same global batch from one
seeded stream and trains on its block of it.

    python -m kungfu_tpu_torch.examples.convergence_bert --world 8 \\
        --backend gloo --steps 200

prints ``step ...`` lines every 20 steps and a final ``CONVERGENCE
{...}`` line, and fails if the final loss is above ``--target``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..models.bert import bert_tiny
from ..training import broadcast_variables, build_train_step
from ..utils.device import default_dtype
from . import ranks
from .bert_sma_gns import mlm_loss_fn, sma_gns_optimizer

VOCAB, SEQ, MASK_ID, TEMPLATES = 512, 64, 0, 64


def template_bank() -> np.ndarray:
    """A fixed bank of "sentences": any unmasked context identifies the
    template, so masked tokens are predictable."""
    rng = np.random.RandomState(7)
    return rng.randint(1, VOCAB, (TEMPLATES, SEQ)).astype(np.int32)


def sample_batch(bank, rng, n):
    tokens = bank[rng.randint(0, len(bank), n)]
    is_masked = rng.rand(*tokens.shape) < 0.15
    masked = np.where(is_masked, MASK_ID, tokens)
    return (tokens.astype(np.int32), masked.astype(np.int32),
            is_masked.astype(np.float32))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-per-lane", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--target", type=float, default=5.0,
                    help="required final MLM loss (upper bound)")
    ap.add_argument("--json", default=None)
    ranks.add_args(ap)
    return ap.parse_args(argv)


def train(args, device, group=None, model=None) -> dict:
    """The training loop on this rank; ``model`` (a ``bert_tiny`` of the
    script's sizes) defaults to one initialised from seed 0.  Returns the
    result record with the curve and, under ``"losses"`` and
    ``"noise_scales"``, every step's mean loss and noise scale."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if model is None:
        model = bert_tiny(vocab_size=VOCAB, max_len=SEQ,
                          dtype=default_dtype(device)).to(device).init(0)
    params = dict(model.named_parameters())
    broadcast_variables(params, group)
    opt = sma_gns_optimizer(params, args.lr, args.batch_per_lane, group)
    step = build_train_step(mlm_loss_fn(model), opt, params, group)
    bank = template_bank()
    rng = np.random.RandomState(0)      # identical streams; each rank slices
    losses, noise = [], []
    for _ in range(args.steps):
        batch = tuple(torch.from_numpy(a).to(device) for a in sample_batch(
            bank, rng, args.batch_per_lane * n))
        losses.append(step(batch))
        noise.append(opt.noise_scale)
    losses = torch.stack(losses).tolist()
    noise = torch.stack(noise).tolist()
    curve = [{"step": i, "mlm_loss": round(losses[i], 4),
              "noise_scale": round(noise[i], 1)}
             for i in range(args.steps)
             if i % 20 == 0 or i == args.steps - 1]
    final = curve[-1]["mlm_loss"]
    return {"mode": "bert_sma_gns", "steps": args.steps, "lanes": n,
            "processes": n, "initial_loss": curve[0]["mlm_loss"],
            "final_loss": final, "curve": curve, "target": args.target,
            "reached": final <= args.target, "losses": losses,
            "noise_scales": noise}


def run(args, device) -> None:
    result = train(args, device)
    if args.rank == 0:
        for c in result["curve"]:
            print(f"step {c['step']:4d}: mlm_loss={c['mlm_loss']:.4f} "
                  f"noise_scale={c['noise_scale']:.1f}")
        record = {k: v for k, v in result.items()
                  if k not in ("losses", "noise_scales")}
        print("CONVERGENCE " + json.dumps(
            {k: v for k, v in record.items() if k != "curve"}), flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(record, f, indent=2)
    if not result["reached"]:
        raise SystemExit(f"loss {result['final_loss']:.4f} > target "
                         f"{args.target}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    return ranks.main(__spec__.name, parse_args(argv), argv, run)


if __name__ == "__main__":
    sys.exit(main())
