"""BERT pretraining with SMA + gradient-noise-scale monitoring
(counterpart of examples/bert_sma_gns.py).

Masked-LM pretraining of a tiny BERT encoder under synchronous model
averaging, with the gradient noise scale estimated online from the same
collective: ``synchronous_averaging(gradient_noise_scale(Adam,
apply="local"))``.  Uniform-random tokens, so the loss cannot fall below
ln(vocab): this shows the wiring; ``convergence_bert`` shows convergence.

    python -m kungfu_tpu_torch.examples.bert_sma_gns --world 2 --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..models.bert import bert_tiny
from ..optimizers import gradient_noise_scale, synchronous_averaging
from ..training import broadcast_variables, build_train_step
from ..utils.device import default_dtype
from ..utils.tree import tree_leaves
from . import ranks

VOCAB, SEQ, MASK_ID = 512, 64, 0
PER_RANK_BATCH = 4


def mlm_loss_fn(model):
    """Mean cross-entropy over the masked positions."""
    def loss_fn(p, batch):
        tokens, masked, is_masked = batch
        logits = torch.func.functional_call(model, p, (masked,))
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              tokens.reshape(-1).long(), reduction="none")
        w = is_masked.reshape(-1)
        return (nll * w).sum() / w.sum().clamp_min(1)
    return loss_fn


def sma_gns_optimizer(params, lr: float, batch_size: int, group=None):
    """The examples' chain: SMA (alpha 0.1) over the GNS monitor over
    Adam, the monitor handing the local gradient through."""
    return synchronous_averaging(gradient_noise_scale(
        torch.optim.Adam(tree_leaves(params), lr=lr, betas=(0.9, 0.999),
                         eps=1e-8),
        batch_size=batch_size, group=group, apply="local"),
        alpha=0.1, group=group)


def run(args, device) -> None:
    n = args.world
    rng = np.random.RandomState(0)
    rng.randint(1, VOCAB, (2, SEQ))     # the JAX script's init tokens
    model = bert_tiny(vocab_size=VOCAB, max_len=SEQ,
                      dtype=default_dtype(device)).to(device).init(0)
    params = dict(model.named_parameters())
    broadcast_variables(params)
    opt = sma_gns_optimizer(params, 1e-3, PER_RANK_BATCH)
    step = build_train_step(mlm_loss_fn(model), opt, params)

    def sample():
        tokens = rng.randint(1, VOCAB, (n * PER_RANK_BATCH, SEQ))
        is_masked = rng.rand(*tokens.shape) < 0.15
        masked = np.where(is_masked, MASK_ID, tokens)
        return tuple(torch.from_numpy(a).to(device) for a in (
            tokens.astype(np.int32), masked.astype(np.int32),
            is_masked.astype(np.float32)))

    for i in range(args.steps):
        loss = float(step(sample()))
        if args.rank == 0:
            print(f"step {i}: mlm_loss={loss:.4f} "
                  f"noise_scale={float(opt.noise_scale):.1f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ranks.add_args(ap)
    argv = sys.argv[1:] if argv is None else argv
    return ranks.main(__spec__.name, ap.parse_args(argv), argv, run)


if __name__ == "__main__":
    sys.exit(main())
