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
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading

import torch

from ..checkpoint import restore_npz_like
from ..models import gpt as G
from ..utils.device import default_dtype, resolve_device
from .engine import DecodeEngine
from .server import ServingServer


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
    args = ap.parse_args(argv)
    if args.weights_int8_min_size and not args.weights_int8:
        ap.error("--weights-int8-min-size requires --weights-int8 (it "
                 "restricts which weights quantize, it does not enable "
                 "quantization)")

    device = resolve_device(args.device)
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
    eng = DecodeEngine(params, cfg, num_slots=args.slots,
                       block_size=args.block, num_blocks=args.blocks,
                       prompt_buckets=buckets, decode_chunk=args.chunk,
                       max_len=args.max_len,
                       kv_dtype=torch.int8 if args.kv_int8 else None,
                       speculative=args.speculative,
                       prefix_cache=args.prefix_cache,
                       weights_int8=args.weights_int8,
                       weights_int8_min_size=args.weights_int8_min_size,
                       device=device)
    del params                      # the engine holds its own copy
    srv = ServingServer(eng, host=args.host, port=args.port).start()
    # handlers before the readiness line: a supervisor reacting to it may
    # signal immediately, and that must reach the graceful shutdown
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    print(f"SERVING ready on {srv.host}:{srv.port}", flush=True)
    done.wait()
    print("serving: shutting down", file=sys.stderr)
    srv.close()


if __name__ == "__main__":
    main()
