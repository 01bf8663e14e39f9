"""ResNet-50 training throughput (images/s per GPU) on one card: the
worker of the repo's ``bench.py`` on the port.

Trains through the path users run: ``build_train_step_with_state`` with
``synchronous_sgd(SGD(0.1, momentum 0.9, nesterov))`` over the peer
group (the gradients' mean in one fused all-reduce, as XLA combines the
JAX step's), the BatchNorm running statistics averaged over it after
each step, softmax cross-entropy on the f32 head.  The model computes in bf16
over f32 parameters (the model's own ``dtype``; no ``compute_dtype``, as
``bench.py`` runs it).  The inputs are ``bench.py``'s: one batch of
``RandomState(0).rand(batch, 224, 224, 3)`` images and
``randint(0, 10)`` labels, stepped over ``--warmup`` then ``--iters``
times; a host clock runs around the timed steps, which end in a host
fetch of the loss.  The weights are drawn from a ``torch.Generator``
seeded 0.

    python -m kungfu_tpu_torch.benchmarks.resnet            # the card
    python -m kungfu_tpu_torch.benchmarks.resnet --device cpu \\
        --stage-sizes 1,1 --num-filters 8 --num-classes 10 \\
        --image-size 32 --small-inputs --f32 --batch 8 --iters 2 --warmup 1

Prints one JSON line: images/s per GPU beside the 360 images/s of one
V100 (``bench.py``'s baseline, BASELINE.json), the model FLOPs (three
times the forward's, counted from the conv and dense shapes) over the
card's 989 TFLOP/s bf16 peak, peak memory, and the card's name and power
limit.  The metric is ``resnet50_images_per_sec_per_gpu`` only for
ResNet-50 on the card; other model arguments name the model they ran,
and a CPU run's metric starts with ``cpu_``.  Without a card the default
run raises; it never falls back to the CPU or to a smaller model.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

BASELINE_IMAGES_PER_SEC = 360.0  # one V100 of 8, NCCL sync SGD (bench.py)
BF16_FLOPS = 989e12              # H100 SXM dense bf16 peak
RESNET50 = dict(stage_sizes=[3, 4, 6, 3], num_filters=64, num_classes=1000,
                image_size=224, small_inputs=False, dtype=torch.bfloat16)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ResNet training throughput")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--stage-sizes", default="3,4,6,3",
                   help="blocks per stage (3,4,6,3 = ResNet-50)")
    p.add_argument("--num-filters", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--small-inputs", action="store_true",
                   help="the CIFAR stem: 3x3 conv, no max-pool")
    p.add_argument("--f32", action="store_true",
                   help="float32 compute instead of bfloat16")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    args.stage_sizes = [int(s) for s in args.stage_sizes.split(",")]
    args.dtype = torch.float32 if args.f32 else torch.bfloat16
    return args


def model_tag(args) -> str:
    """``resnet50`` for ResNet-50 as bench.py trains it, else a name that
    spells out the arguments."""
    if all(getattr(args, k) == v for k, v in RESNET50.items()):
        return "resnet50"
    dt = "f32" if args.dtype == torch.float32 else "bf16"
    return (f"resnet{'-'.join(map(str, args.stage_sizes))}"
            f"_f{args.num_filters}_c{args.num_classes}_i{args.image_size}"
            f"{'_small' if args.small_inputs else ''}_{dt}")


def make_model(args, device):
    from ..models.resnet import ResNet
    return ResNet(args.stage_sizes, args.num_classes, args.num_filters,
                  args.dtype, args.small_inputs).to(device).init(0)


def make_loss_fn(model):
    """``loss_fn(params, model_state, batch) -> (loss, new_state)`` for
    :func:`~kungfu_tpu_torch.training.build_train_step_with_state`: the
    module in train mode through ``torch.func.functional_call`` on the
    parameter tree and a copy of the state, which BatchNorm updates; mean
    softmax cross-entropy of the f32 logits."""
    def loss_fn(params, mstate, batch):
        x, y = batch
        state = {k: v.clone() for k, v in mstate.items()}
        logits = torch.func.functional_call(model, {**params, **state},
                                            (x,))
        return F.cross_entropy(logits, y.long()), state
    return loss_fn


def host_batch(args):
    """bench.py's batch on the host: NHWC f32 images and int labels."""
    rng = np.random.RandomState(0)
    x = rng.rand(args.batch, args.image_size, args.image_size,
                 3).astype(np.float32)
    return x, rng.randint(0, 10, size=args.batch)


def make_batch(args, device):
    """bench.py's batch on ``device``: the NHWC images as an NCHW
    channels-last view."""
    x, y = host_batch(args)
    return (torch.from_numpy(x).permute(0, 3, 1, 2).to(device),
            torch.from_numpy(y).to(device))


def build_step(model, group):
    """The synchronous-SGD nesterov step over ``model``'s parameters and
    buffers (``bench.py:145-151``)."""
    from ..optimizers import synchronous_sgd
    from ..training import broadcast_variables, build_train_step_with_state
    params = dict(model.named_parameters())
    state = dict(model.named_buffers())
    broadcast_variables(params, group)
    broadcast_variables(state, group)
    # fusion: one all-reduce per dtype for the 161 gradients, as XLA
    # combines the JAX step's; the mean is the same
    opt = synchronous_sgd(torch.optim.SGD(
        params.values(), lr=0.1, momentum=0.9, nesterov=True), group,
        fusion=True)
    return build_train_step_with_state(make_loss_fn(model), opt, params,
                                       state, group)


def train(args, device) -> dict:
    """Build the step as bench.py does and run it; the result holds the
    JSON fields and the first and last losses.  The caller has joined the
    peer group (:func:`~kungfu_tpu_torch.benchmarks.gpt.solo_group`)."""
    from ..comm.mesh import flat_mesh
    from .gpt import device_name

    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cudnn.benchmark = True   # the warm-up autotunes
        torch.cuda.reset_peak_memory_stats()
    model = make_model(args, device).train()
    step = build_step(model, flat_mesh(n=1))
    batch = make_batch(args, device)
    first = float(step(batch))
    for _ in range(args.warmup - 1):
        loss = step(batch)
    if args.warmup > 1:
        float(loss)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        loss = step(batch)
    last = float(loss)                   # forces the chained sequence
    dt = time.perf_counter() - t0
    images_per_sec = args.batch * args.iters / dt
    tag = model_tag(args)
    flops = 3 * model.forward_flops(args.image_size, args.image_size)
    out = {"metric": (f"{tag}_images_per_sec_per_gpu" if cuda
                      else f"cpu_{tag}_images_per_sec"),
           "value": round(images_per_sec, 2),
           "unit": "images/sec/gpu" if cuda else "images/sec",
           "batch": args.batch, "iters": args.iters,
           "train_flops_per_image": flops,
           "params": sum(p.numel() for p in model.parameters()),
           "loss_first": first, "loss_last": last,
           "seconds": dt, "backend": device.type,
           "device": device_name(device)}
    if cuda:
        out["vs_baseline"] = round(images_per_sec / BASELINE_IMAGES_PER_SEC,
                                   3)
        out["baseline"] = ("360 images/s per V100 (8xV100 NCCL sync SGD, "
                           "bench.py)")
        out[f"{tag}_mfu"] = images_per_sec * flops / BF16_FLOPS
        out["model_tflops_per_sec"] = images_per_sec * flops / 1e12
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..utils.device import resolve_device
    from .gpt import solo_group

    if args.batch < 1 or args.iters < 1 or args.warmup < 1:
        raise SystemExit("--batch, --iters and --warmup must be >= 1")
    device = resolve_device(args.device)
    with solo_group(device):
        out = train(args, device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
