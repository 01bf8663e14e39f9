"""Long-context attention by sequence parallelism (counterpart of
examples/long_context_ring_attention.py).

The sequence is sharded over the ranks: each holds T/n tokens, and the
K/V blocks rotate around the ring while an online softmax accumulates,
so memory per rank stays O(T/n).  Ring attention, Ulysses and ring
attention on the flash kernels, each against dense attention over the
whole sequence.  Head dim 64 (the flash kernels take 64 or 128; the JAX
example uses 32).

    python -m kungfu_tpu_torch.examples.long_context_ring_attention \\
        --world 4 --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import (make_ring_attention, make_ring_flash_attention,
                        make_ulysses_attention, reference_attention)
from . import ranks


def run(args, device) -> None:
    n = args.world
    B, T, H, D = 2, 128 * n, n, 64  # H divisible by n for Ulysses
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)
                                * 0.1).to(device, dtype) for _ in range(3))
    group = dist.group.WORLD
    dense = reference_attention(q, k, v, causal=True)
    for name, fn in (("ring", make_ring_attention(group, causal=True)),
                     ("ulysses", make_ulysses_attention(group, causal=True)),
                     ("ring_flash", make_ring_flash_attention(group,
                                                              causal=True))):
        out = fn(q, k, v)
        err = float((out.float() - dense.float()).abs().max())
        if args.rank == 0:
            print(f"{name:10s} attention: seq={T} over {n} ranks, "
                  f"max err vs dense = {err:.2e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ranks.add_args(ap)
    argv = sys.argv[1:] if argv is None else argv
    return ranks.main(__spec__.name, ap.parse_args(argv), argv, run)


if __name__ == "__main__":
    sys.exit(main())
