"""GPT causal-LM training throughput (tokens/s) on one card
(counterpart of kungfu_tpu/benchmarks/gpt.py).

Trains the GPT family through the path users run: the synchronous-SGD
step over the peer group, flash attention on the card, chunked-vocab
cross-entropy, bf16 compute with f32 master weights.  Prints one JSON
line with tokens/s and model TFLOP/s (6 N FLOPs per token plus the
attention term, as the JAX benchmark counts them).

    python -m kungfu_tpu_torch.benchmarks.gpt --preset 470m
    python -m kungfu_tpu_torch.benchmarks.gpt --device cpu --d-model 64 \\
        --n-layers 2 --n-heads 4 --d-ff 128 --vocab 256 --seq 64 \\
        --batch 4 --steps 2 --warmup-steps 1

The JAX run has no seed flag: tokens come from ``np.random.RandomState(0)``
and the weights from a ``torch.Generator`` seeded 0.  One process, one
card: the peer group is a world of 1 (NCCL on the card, gloo on the CPU)
joined through a ``FileStore`` in a temporary directory.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# one-flag reproductions of the JAX benchmark's rows; every field can
# still be overridden by an explicit flag AFTER --preset
PRESETS = {
    "164m": ["--seq", "2048", "--batch", "64", "--n-kv-heads", "4",
             "--rope", "--swiglu", "--accum", "16",
             "--chunked-ce", "16384"],
    "470m": ["--d-model", "1024", "--n-layers", "24", "--n-heads", "16",
             "--n-kv-heads", "4", "--d-ff", "4096", "--seq", "2048",
             "--batch", "64", "--rope", "--swiglu", "--accum", "32",
             "--chunked-ce", "16384"],
    "164m-long": ["--seq", "8192", "--batch", "16", "--n-kv-heads", "4",
                  "--rope", "--swiglu", "--accum", "16",
                  "--chunked-ce", "8192"],
    # head_dim 128 variants: same d_model/d_ff/params, half the heads
    "164m-hd128": ["--seq", "2048", "--batch", "64", "--n-heads", "6",
                   "--n-kv-heads", "2", "--rope", "--swiglu",
                   "--accum", "16", "--chunked-ce", "16384"],
    "164m-long-hd128": ["--seq", "8192", "--batch", "16",
                        "--n-heads", "6", "--n-kv-heads", "2",
                        "--rope", "--swiglu", "--accum", "16",
                        "--chunked-ce", "8192"],
    "470m-hd128": ["--d-model", "1024", "--n-layers", "24",
                   "--n-heads", "8", "--n-kv-heads", "2",
                   "--d-ff", "4096", "--seq", "2048", "--batch", "64",
                   "--rope", "--swiglu", "--accum", "32",
                   "--chunked-ce", "16384"],
}

def parse_args(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # --preset's flags go FIRST so explicit flags win
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--preset", choices=list(PRESETS))
    known, rest = pre.parse_known_args(argv)
    argv = (PRESETS[known.preset] + rest) if known.preset else rest
    p = argparse.ArgumentParser(description="GPT training throughput")
    p.add_argument("--preset", choices=list(PRESETS), default=None,
                   help="flag bundle of a benchmark row (applied before "
                        "other flags, which override it)")
    p.set_defaults(preset=known.preset)
    p.add_argument("--vocab", type=int, default=32768)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--n-heads", type=int, default=12)
    p.add_argument("--n-kv-heads", type=int, default=0,
                   help="GQA KV heads (0 = MHA)")
    p.add_argument("--d-ff", type=int, default=3072)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup-steps", type=int, default=3)
    p.add_argument("--rope", action="store_true")
    p.add_argument("--swiglu", action="store_true")
    p.add_argument("--remat", nargs="?", const="full", default="",
                   choices=["", "none", "full", "attn", "ffn"],
                   help="per-layer rematerialization: 'full' saves only "
                        "each block's input; 'attn' keeps the attention "
                        "residuals so the backward never re-runs the flash "
                        "forward; 'ffn' recomputes only the norm+FFN")
    p.add_argument("--attn", default="auto",
                   help="auto | flash | dense")
    p.add_argument("--f32", action="store_true",
                   help="float32 instead of bfloat16")
    p.add_argument("--decode", action="store_true",
                   help="measure KV-cache autoregressive generation "
                        "instead of training")
    p.add_argument("--chunked-ce", type=int, default=0, metavar="CHUNK",
                   help="chunked-vocab cross-entropy (no [B,T,V] logits); "
                        "value = vocab chunk")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--prompt-len", type=int, default=128,
                   help="decode mode: prompt length to prefill")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def param_count(params) -> int:
    from ..utils.tree import tree_leaves
    return sum(t.numel() for t in tree_leaves(params))


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def make_config(args):
    from ..models.gpt import GPTConfig
    return GPTConfig(vocab_size=args.vocab, d_model=args.d_model,
                     n_heads=args.n_heads, n_layers=args.n_layers,
                     d_ff=args.d_ff, max_seq=args.seq,
                     dtype=torch.float32 if args.f32 else torch.bfloat16,
                     n_kv_heads=args.n_kv_heads or None, rope=args.rope,
                     mlp="swiglu" if args.swiglu else "gelu")


def make_loss_fn(args, cfg):
    from ..models.gpt import forward_features, forward_local, \
        parallel_cross_entropy
    from ..ops.chunked_ce import chunked_cross_entropy

    if args.chunked_ce:
        def loss_fn(p, batch):
            bt, by = batch
            feats = forward_features(p, bt, cfg, attn=args.attn,
                                     remat=args.remat)
            # head in the model dtype (the f32 master stays in params)
            head = p["lm_head"].to(cfg.dtype)
            return chunked_cross_entropy(feats, head, by,
                                         args.chunked_ce).mean()
    else:
        def loss_fn(p, batch):
            bt, by = batch
            logits = forward_local(p, bt, cfg, attn=args.attn,
                                   remat=args.remat)
            return parallel_cross_entropy(logits, by).mean()
    return loss_fn


@contextlib.contextmanager
def solo_group(device: torch.device):
    """The peer group of a one-process run: a world of 1 joined through a
    FileStore in a temporary directory (NCCL on the card, gloo on the
    CPU), destroyed on exit."""
    import torch.distributed as dist
    from ..comm.mesh import init_process_group_file

    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)        # NCCL binds the current card
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group_file(os.path.join(tmp, "store"), 0, 1,
                                "nccl" if device.type == "cuda" else "gloo")
        try:
            yield
        finally:
            dist.destroy_process_group()


def train(args, device: torch.device) -> dict:
    """Build the step as the JAX benchmark does and run it; the result
    holds the per-step losses and times and the trained parameters
    besides the JSON fields.  The caller has joined the peer group
    (:func:`solo_group`)."""
    from ..comm.mesh import flat_mesh
    from ..models.gpt import init_params
    from ..optimizers import synchronous_sgd
    from ..training import broadcast_variables, build_train_step
    from ..utils.tree import tree_leaves

    cfg = make_config(args)
    if args.accum < 1 or args.batch % args.accum:
        raise SystemExit(f"--accum {args.accum} must be >= 1 and divide "
                         f"--batch {args.batch}")
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = param_count(params)
    group = flat_mesh(n=1)
    broadcast_variables(params, group)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        (args.batch, args.seq))).to(
        device=device, dtype=torch.int32)
    tgts = torch.roll(toks, -1, dims=1)
    # optax.adamw(3e-4)'s defaults, spelled out (torch's differ)
    opt = synchronous_sgd(torch.optim.AdamW(
        tree_leaves(params), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4), group)
    step = build_train_step(make_loss_fn(args, cfg), opt, params, group,
                            accum_steps=args.accum,
                            compute_dtype=None if args.f32 else cfg.dtype)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    losses, times = [], []
    for i in range(args.warmup_steps + args.steps):
        t0 = time.perf_counter()
        loss = float(step((toks, tgts)))          # host fetch = sync
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    dt = sum(times[args.warmup_steps:])
    tok_per_sec = args.batch * args.seq * args.steps / dt
    # 6ND fwd+bwd FLOPs/token + attention term 12*L*D*T (causal halved)
    flops_per_tok = 6 * n_params + 6 * cfg.n_layers * cfg.d_model * args.seq
    tflops = tok_per_sec * flops_per_tok / 1e12
    return {"metric": "gpt_tokens_per_sec_per_chip",
            "value": round(tok_per_sec, 1), "unit": "tokens/sec/chip",
            "params": n_params, "model_tflops_per_sec": round(tflops, 2),
            "loss": round(losses[-1], 4), "backend": device.type,
            "device": device_name(device),
            "step_losses": losses, "step_seconds": times,
            "flops_per_token": flops_per_tok, "params_tree": params}


def decode(args, device: torch.device) -> dict:
    """KV-cache generation throughput: prefill a prompt, then greedy-
    decode ``--seq - --prompt-len`` new tokens."""
    from ..models.gpt import cast_params, generate, init_params

    if args.prompt_len <= 0:
        raise SystemExit("--prompt-len must be positive in decode mode")
    n_new = args.seq - args.prompt_len
    if n_new <= 0:
        raise SystemExit("--seq must exceed --prompt-len in decode mode")
    cfg = make_config(args)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = param_count(params)
    params = cast_params(params, cfg)
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
    out = generate(params, cfg, prompt, n_new, max_len=args.seq)
    out.cpu()                                          # warm-up + sync
    t0 = time.perf_counter()
    for _ in range(args.steps):
        out = generate(params, cfg, prompt, n_new, max_len=args.seq)
    out.cpu()
    dt = time.perf_counter() - t0
    return {"metric": "gpt_decode_tokens_per_sec_per_chip",
            "value": round(args.batch * n_new * args.steps / dt, 1),
            "unit": "tokens/sec/chip", "params": n_params,
            "prompt_len": args.prompt_len, "new_tokens": n_new,
            "batch": args.batch, "reps": args.steps,
            "backend": device.type, "device": device_name(device)}


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if args.decode:
        if (args.attn != "auto" or args.remat not in ("", "none")
                or args.chunked_ce or args.accum != 1):
            raise SystemExit("--attn/--remat/--chunked-ce/--accum apply to "
                             "training only; the decode loop always runs "
                             "dense per-token attention over the KV cache")
        print(json.dumps(decode(args, device)))
        return 0
    with solo_group(device):
        out = train(args, device)
    print(json.dumps({k: out[k] for k in (
        "metric", "value", "unit", "params", "model_tflops_per_sec",
        "loss", "backend", "device")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
