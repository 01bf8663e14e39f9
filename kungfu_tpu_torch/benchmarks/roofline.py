"""Kernel roofline on one card (counterpart of
kungfu_tpu/benchmarks/roofline.py).

Measures, at the GPT benchmark's attention shapes (T=2048, 12 heads of 64
or 8 heads of 128, batch 4, bf16):

- the bf16 matmul ceiling: ``torch.matmul`` at 4096^3 (the JAX harness
  leaves its matmul to XLA too);
- flash attention forward and forward+backward, causal, through the
  port's K1-K4 (``ops/flash_attention.py``); the backward takes the
  gradients of q, k and v, so K2, K3 and K4 all run;
- K6, :func:`nosoftmax_attention`: K1's tile loop with the softmax
  deleted, the ceiling the real kernel's softmax eats into;
- SDPA's forward at the flash shapes, a library yardstick the port never
  calls (the JAX harness's control is the platform's own flash kernel);
- the HBM ceiling: ``x * c`` over 512 MiB of f32, one read and one write;

and writes one JSON artifact in the JAX harness's schema: ``results``
rows ``{"op", "seconds", "tflops"}`` or ``{"op", "seconds", "gib_per_s"}``
with the same op prefixes, so ``kungfu_tpu.monitor.profiler.load_ceilings``
reads it, plus ``"ms"`` per call and the card's name and power limit.
``seconds`` is one timed run of ``reps`` back-to-back calls (the median
of 25 runs, see :mod:`.timing`); the rates are per call.

    python -m kungfu_tpu_torch.benchmarks.roofline            # the card
    python -m kungfu_tpu_torch.benchmarks.roofline --tiny --device cpu

``--tiny --device cpu`` runs the JAX harness's tiny shapes through the
plain versions: a check of the harness, not a measurement of a device.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import flash_attention as FA
from ..utils.device import resolve_device
from .gpt import device_name
from .timing import Timer

TILE = 64                     # K6's CUDA blocks: 64 query rows by 64 keys

# K6 launches since the last reset (the wrapper adds one per launch)
launches = {"nosoftmax": 0}


# ------------------------------------------------------------------- K6
def _block_keep(T: int, causal: bool, bq: int, bk: int, device):
    """[T, T] bool: key s is read by query t when its k-block is visible
    to t's q-block, ``ik * bk <= iq * bq + bq - 1`` (every pair when not
    causal).  No mask inside a block."""
    if not causal:
        return torch.ones((T, T), dtype=torch.bool, device=device)
    iq = torch.arange(T, device=device) // bq
    ik = torch.arange(T, device=device) // bk
    return ik[None, :] * bk <= iq[:, None] * bq + bq - 1


def _nosoftmax_masked(q, k, v, keep):
    """bf16(q k^T) v over the (query, key) pairs of ``keep``: s in f32,
    rounded to v's dtype, the second product in f32, out in q's dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = torch.where(keep, s, 0.0).to(v.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", s, v.float()).to(q.dtype)


def _nosoftmax_plain(q, k, v, causal: bool = False, bq: int = TILE,
                     bk: int = TILE):
    """The plain version of K6 (and of the JAX ``_nosoftmax_kernel`` at
    blocks ``bq`` x ``bk``): q, k, v [B, H, T, D]."""
    return _nosoftmax_masked(q, k, v,
                             _block_keep(q.shape[2], causal, bq, bk, q.device))


def _visible_block_pairs(T: int, causal: bool, bq: int, bk: int) -> int:
    """(q-block, k-block) pairs that K6 computes per (batch, head)."""
    n_q, n_k = -(-T // bq), -(-T // bk)
    if not causal:
        return n_q * n_k
    return sum(min(n_k, (iq * bq + bq - 1) // bk + 1) for iq in range(n_q))


def nosoftmax_attention(q, k, v, causal: bool = False, bq: int = TILE,
                        bk: int = TILE):
    """K6: bf16(q k^T) v with the causal block skip, q, k, v [B, H, T, D]
    bf16.  CPU tensors take the plain version at blocks ``bq`` x ``bk``.
    CUDA tensors launch the kernel, whose blocks are 64 x 64: under
    ``causal`` the result depends on the blocks (a block straddling the
    diagonal is computed whole), so other blocks raise."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"nosoftmax_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be one "
                         f"[B, H, T, D] shape")
    if FA._device_kind(q, "nosoftmax_attention") == "cpu":
        return _nosoftmax_plain(q, k, v, causal, bq, bk)
    if (bq, bk) != (TILE, TILE):
        raise ValueError(f"nosoftmax_attention: the CUDA kernel computes "
                         f"blocks of {TILE} x {TILE}, not {bq} x {bk}")
    FA._check("nosoftmax_attention", {"q": q, "k": k, "v": v},
              dtype=torch.bfloat16)
    B, H, T, D = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    # (batch, time, head) strides of [B, H, T, D] tensors
    st = lambda t: (ctypes.c_longlong * 3)(t.stride(0), t.stride(2),
                                           t.stride(1))
    with torch.cuda.device(q.device):
        FA._run("kft_nosoftmax_fwd", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), st(q), st(k), st(v), st(out),
                B, H, T, D, int(causal), FA._stream(q))
    launches["nosoftmax"] += 1
    return out


# ---------------------------------------------------------------- rows
def _attn_flops(B, T, H, D, with_bwd: bool) -> float:
    # causal fwd: QK^T (2*T*T*D) + PV (2*T*T*D) per head per batch, halved
    f = 4.0 * B * H * T * T * D * 0.5
    # bwd recomputes p and forms 4 more T*T*D-scale matmuls (dv, dp, dq,
    # dk) ~ 2.5x the forward
    return f * (3.5 if with_bwd else 1.0)


def _row(op: str, ms: float, reps: int, **rates) -> dict:
    return {"op": op, "seconds": ms * reps / 1e3, "ms": ms, "reps": reps,
            **rates}


def _randn(shape, device, rng):
    return torch.from_numpy(rng.randn(*shape)).to(device, torch.bfloat16)


def bench_matmul(timer: Timer, n: int, reps: int) -> dict:
    """Square bf16 matmul (f32 accumulation in the library GEMM)."""
    rng = np.random.RandomState(0)
    a = _randn((n, n), timer.device, rng)
    b = _randn((n, n), timer.device, rng)
    ms = timer(lambda: torch.matmul(a, b), reps=reps)
    return _row(f"matmul_{n}x{n}x{n}_bf16", ms, reps,
                tflops=2.0 * n ** 3 / ms / 1e9)


def bench_flash(timer: Timer, B, T, H, D, reps: int, with_bwd: bool) -> dict:
    """The port's causal flash attention, [B, T, H, D] bf16; with
    ``with_bwd`` the gradients of q, k and v under an all-ones output
    cotangent (the JAX harness's ``sum(out)`` loss)."""
    rng = np.random.RandomState(0)
    q, k, v = (_randn((B, T, H, D), timer.device, rng) for _ in range(3))
    if with_bwd:
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        dout = torch.ones_like(q)

        def op():
            out = FA.flash_attention(q, k, v, causal=True)
            return torch.autograd.grad(out, (q, k, v), dout)
    else:
        def op():
            with torch.no_grad():
                return FA.flash_attention(q, k, v, causal=True)
    ms = timer(op, reps=reps)
    name = f"flash_{'fwdbwd' if with_bwd else 'fwd'}_B{B}_T{T}_H{H}_D{D}"
    return _row(name, ms, reps,
                tflops=_attn_flops(B, T, H, D, with_bwd) / ms / 1e9)


def bench_kernel_ceiling(timer: Timer, B, T, H, D, reps: int,
                         causal: bool = False) -> dict:
    """K6 on [B, H, T, D] bf16.  ``tflops`` counts the JAX harness's
    useful flops (T^2 / 2 under causal), so the row compares with the
    flash rows; ``flops_done`` is what the kernel computes: every visible
    block pair whole."""
    rng = np.random.RandomState(0)
    q, k, v = (_randn((B, H, T, D), timer.device, rng) for _ in range(3))
    ms = timer(lambda: nosoftmax_attention(q, k, v, causal), reps=reps)
    tag = "causal_" if causal else ""
    flops = 4.0 * B * H * T * T * D * (0.5 if causal else 1.0)
    done = 4.0 * B * H * D * TILE * TILE * _visible_block_pairs(
        T, causal, TILE, TILE)
    return _row(f"kernel_ceiling_matmul_only_{tag}B{B}_T{T}_H{H}_D{D}", ms,
                reps, tflops=flops / ms / 1e9, flops_done=done)


def bench_library_flash(timer: Timer, B, T, H, D, reps: int) -> dict:
    """SDPA's causal forward at the flash shapes ([B, H, T, D] bf16): the
    library yardstick, never called by the port."""
    rng = np.random.RandomState(0)
    q, k, v = (_randn((B, H, T, D), timer.device, rng) for _ in range(3))
    ms = timer(lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True),
               reps=reps)
    return _row(f"library_flash_fwd_B{B}_T{T}_H{H}_D{D}", ms, reps,
                tflops=_attn_flops(B, T, H, D, False) / ms / 1e9)


def bench_hbm(timer: Timer, mib: int, reps: int) -> dict:
    """Elementwise scale: one read and one write per f32 element."""
    n = mib * (1 << 20) // 4
    x = torch.ones(n, dtype=torch.float32, device=timer.device)
    ms = timer(lambda: x * 1.0000001, reps=reps)
    return _row(f"hbm_copy_{mib}MiB", ms, reps,
                gib_per_s=2.0 * n * 4 / (1 << 30) / ms * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="kernel roofline artifact")
    ap.add_argument("--out", default="ROOFLINE_torch.json")
    ap.add_argument("--tiny", action="store_true",
                    help="small shapes (a check of the harness)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    timer = Timer(device)
    if args.tiny:
        rows = [bench_matmul(timer, 256, reps=4),
                bench_flash(timer, 1, 256, 2, 64, reps=2, with_bwd=False),
                bench_flash(timer, 1, 256, 2, 64, reps=2, with_bwd=True),
                bench_kernel_ceiling(timer, 1, 256, 2, 64, reps=2),
                bench_library_flash(timer, 1, 256, 2, 64, reps=2),
                bench_hbm(timer, 16, reps=4)]
    else:
        # head_dim 64 and 128 at the same total width (12 x 64, 8 x 128)
        rows = [bench_matmul(timer, 4096, reps=8)]
        for H, D in ((12, 64), (8, 128)):
            rows += [bench_flash(timer, 4, 2048, H, D, reps=8,
                                 with_bwd=False),
                     bench_flash(timer, 4, 2048, H, D, reps=4,
                                 with_bwd=True)]
        rows += [bench_kernel_ceiling(timer, 4, 2048, 12, 64, reps=8),
                 bench_kernel_ceiling(timer, 4, 2048, 8, 128, reps=8),
                 bench_kernel_ceiling(timer, 4, 2048, 12, 64, reps=8,
                                      causal=True),
                 bench_kernel_ceiling(timer, 4, 2048, 8, 128, reps=8,
                                      causal=True),
                 bench_library_flash(timer, 4, 2048, 12, 64, reps=8),
                 bench_library_flash(timer, 4, 2048, 8, 128, reps=8),
                 bench_hbm(timer, 512, reps=8)]
    doc = {"platform": device.type, "device": device_name(device),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "results": rows}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    for r in rows:
        print(json.dumps(r))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
