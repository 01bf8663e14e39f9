"""Serve a GPT model over HTTP from the command line, on PyTorch/CUDA.

    python -m kungfu_tpu_torch.serving --d-model 1024 --n-heads 16 \
        --n-kv-heads 4 --n-layers 24 --d-ff 4096 --vocab 32768 \
        --rope --swiglu --npz weights.npz --port 8100

Prints ``SERVING ready on <host>:<port>`` once live, then blocks until
SIGINT/SIGTERM.  Without ``--npz`` the model is seed-initialized;
``--npz`` reads weights written by kungfu_tpu.checkpoint.save_npz.  Runs
on ``cuda`` (bf16) unless ``--device cpu`` (f32) is given.
``--weights-int8 [--weights-int8-min-size N]`` stores the weights as
int8, ``--prefix-cache`` shares prompt-prefix KV blocks, and
``GET /requests?n=`` serves the request journal.

``--tp N`` serves tensor-parallel over N ranks, one process each: this
process is rank 0 (the scheduler and the HTTP server) and starts ranks
1..N-1 itself, joined through a ``FileStore`` in a temporary directory.
``--backend nccl`` (default) puts rank r on ``cuda:r`` and needs N
visible cards; ``--backend gloo`` puts every rank on ``--device``, so
several ranks may share one card (or run on the CPU).  The readiness
line comes once every rank has built its shard; a rank that dies takes
the server down with a nonzero exit.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import torch
import torch.distributed as dist

from ..checkpoint import restore_npz_like
from ..comm.mesh import init_process_group_file, serving_mesh
from ..models import gpt as G
from ..utils.device import default_dtype, resolve_device
from .engine import DecodeEngine
from .server import ServingServer

ROOT = Path(__file__).resolve().parents[2]     # holds kungfu_tpu_torch/


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m kungfu_tpu_torch.serving")
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--n-kv-heads", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=6)
    ap.add_argument("--d-ff", type=int, default=2048)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--rope", action="store_true")
    ap.add_argument("--swiglu", action="store_true")
    ap.add_argument("--npz", default=None,
                    help="weights from kungfu_tpu.checkpoint.save_npz "
                         "(else: seed-initialized demo weights)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--buckets", default="32,128,512",
                    help="comma-separated prefill bucket lengths")
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV cache, dequantized inside the "
                         "paged-attention kernel")
    ap.add_argument("--weights-int8", action="store_true",
                    help="weight-only int8 (W8A16): int8 matmul weights "
                         "and LM head with per-channel scales, each "
                         "layer's weights dequantized at its use; about "
                         "half the resident weight bytes")
    ap.add_argument("--weights-int8-min-size", type=int, default=0,
                    help="quantize only weights with at least this many "
                         "elements (e.g. 10000000: the vocab-sized LM head "
                         "only; 0 = every eligible weight)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV blocks across requests "
                         "(refcounted; suffix-only prefill on a hit)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative decoding with up to K prompt-"
                         "lookup drafts per pass (lossless for greedy)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ranks, one process each (0 = "
                         "one device, no process group); shards the "
                         "parameters and the KV pools")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="the tp ranks' data backend: nccl (rank r on "
                         "cuda:r) or gloo (every rank on --device)")
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.weights_int8_min_size and not args.weights_int8:
        ap.error("--weights-int8-min-size requires --weights-int8 (it "
                 "restricts which weights quantize, it does not enable "
                 "quantization)")
    if args.tp < 0:
        ap.error("--tp must be >= 0")
    if not args.tp:
        return serve(args, resolve_device(args.device), None, [])
    if args.tp_rank is not None:
        return follow(args)
    device = rank_device(args, 0)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        argv = list(sys.argv[1:] if argv is None else argv)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        procs = [subprocess.Popen(
            [sys.executable, "-m", "kungfu_tpu_torch.serving", *argv,
             "--tp-rank", str(r), "--tp-store", store], env=env,
            stdout=subprocess.DEVNULL) for r in range(1, args.tp)]
        try:
            init_process_group_file(store, 0, args.tp, args.backend)
            return serve(args, device, serving_mesh(args.tp), procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            if dist.is_initialized():
                dist.destroy_process_group()


def rank_device(args, rank: int) -> torch.device:
    """Tensor-parallel rank ``rank``'s device: ``cuda:rank`` over nccl
    (which needs ``--tp`` visible cards), ``--device`` over gloo."""
    if args.backend == "gloo":
        return resolve_device(args.device)
    if torch.device(args.device).type != "cuda":
        raise SystemExit("--backend nccl runs on cuda; use --backend gloo "
                         "with --device cpu")
    resolve_device("cuda")
    if torch.cuda.device_count() < args.tp:
        raise SystemExit(f"--tp {args.tp} over nccl but only "
                         f"{torch.cuda.device_count()} cards visible")
    torch.cuda.set_device(rank)
    return resolve_device(f"cuda:{rank}")


def build_engine(args, device, mesh) -> DecodeEngine:
    """The engine of this process (the same arguments and seeded weights
    on every tp rank)."""
    cfg = G.GPTConfig(vocab_size=args.vocab, d_model=args.d_model,
                      n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
                      n_layers=args.n_layers, d_ff=args.d_ff,
                      max_seq=args.max_seq, rope=args.rope,
                      mlp="swiglu" if args.swiglu else "gelu",
                      dtype=default_dtype(device))
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = G.init_params(gen, cfg)
    if args.npz:
        params = restore_npz_like(params, args.npz)
        print(f"serving: restored weights from {args.npz}",
              file=sys.stderr)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    return DecodeEngine(params, cfg, num_slots=args.slots,
                       block_size=args.block, num_blocks=args.blocks,
                       prompt_buckets=buckets, decode_chunk=args.chunk,
                       max_len=args.max_len,
                       kv_dtype=torch.int8 if args.kv_int8 else None,
                       speculative=args.speculative,
                       prefix_cache=args.prefix_cache,
                       weights_int8=args.weights_int8,
                       weights_int8_min_size=args.weights_int8_min_size,
                       device=device, mesh=mesh)


def follow(args) -> int:
    """Tensor-parallel rank ``--tp-rank``: join the group, build the
    shard, run rank 0's programs until it stops the ranks."""
    # rank 0 stops this rank, also when a signal reaches the whole
    # process group; if rank 0 dies, the next command's wait fails
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, signal.SIG_IGN)
    device = rank_device(args, args.tp_rank)
    init_process_group_file(args.tp_store, args.tp_rank, args.tp,
                            args.backend)
    try:
        build_engine(args, device, serving_mesh(args.tp)).follow()
    finally:
        dist.destroy_process_group()
    return 0


def serve(args, device, mesh, followers) -> int:
    """Rank 0 (or the only process): serve until SIGINT/SIGTERM, or until
    a tp rank exits."""
    srv = ServingServer(build_engine(args, device, mesh), host=args.host,
                        port=args.port).start()
    # handlers before the readiness line: a supervisor reacting to it may
    # signal immediately, and that must reach the graceful shutdown
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    print(f"SERVING ready on {srv.host}:{srv.port}", flush=True)
    while not done.wait(0.5):
        if any(p.poll() is not None for p in followers):
            break
    lost = [r for r, p in enumerate(followers, 1) if p.poll() is not None]
    print("serving: shutting down", file=sys.stderr)
    srv.close()
    for r, p in enumerate(followers, 1):
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            lost.append(r)
    if lost or srv.close_error:
        print(f"serving: tensor-parallel ranks {lost} stopped early "
              f"({srv.close_error})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
