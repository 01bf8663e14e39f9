#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kungfu_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --commit-cost
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --serving-tp
    python3 chip_smoke.py --fsdp

With no arguments:

1. builds every CUDA kernel of the port from this checkout (nvcc, into
   kungfu_tpu_torch/_build/), prints each kernel's registers and spills
   (failing if a bf16 K1, K6, K2 or K5 spills) and the card's name and
   power limit;
2. holds the paged-decode kernel (K5) against its plain PyTorch version on
   the card at the 470m serving shapes -- bf16, f32, multi-query, int8
   pool, poisoned scratch block -- shows with planted faults in a plain
   emulation of its split and merge (a dropped newest rank, unweighted
   partials, a past-reach scratch block) that the limit would catch them,
   and times it (the serve's ragged slots, every slot at full length, the
   Q = 4 verify) beside its bound, one launch's floor, the plain version
   and one PyTorch attention call, and checks and times it at a tp-2
   rank's shard (8 query heads, 2 KV heads; bf16 and int8 pools);
3. serves the repo's 470m GPT (kungfu_tpu/benchmarks/gpt.py preset,
   seed-initialized, bf16) over HTTP through the port's ServingServer:
   16 concurrent streamed requests, checking that every decode layer-step
   went through the kernel and that ``GET /requests`` holds one finished
   record per request; profiles steady-state decode chunks
   (torch.profiler: device busy share, launches, top kernels); serves
   the same traffic with int8 weights (tokens equal to the dequantized
   oracle's, resident weight bytes at most 0.6x the bf16 engine's) and
   profiles it; serves 16 requests sharing a 384-token system prompt with
   the prefix cache on and off (16 hits; K5 over aliased block tables;
   the suffix prefill's logits against a full prefill, two planted faults
   above the limit; for each request whose greedy tokens differ with
   the cache on and off, the first index and the f32 logit margin
   there); serves serve_470m's 16 requests at tensor parallelism 2 through
   ``python -m kungfu_tpu_torch.serving --tp 2 --backend gloo`` (2 ranks
   sharing the card): K5 at every decode layer-step on each rank, the
   journal, each rank's collective seconds, weight bytes and peak memory,
   rank 0's prefill logits against the one-device engine's with three
   planted faults above the limit (layer 0's attention-output all-reduce
   skipped, rank 1 holding rank 0's KV heads, the vocabulary blocks
   gathered in reverse), and the margin wherever its greedy tokens part
   from the one-device run's (``serve_470m_tp2``); then a speculative
   (K=3), an int8-KV and an int8 weights + int8-KV + speculative engine
   at 4 layers;
4. checks that greedy tokens of an f32 full-width engine are the same
   with the fused kernel and with the gather path, and, at 2 layers, with
   the prefix cache on and off under a roomy pool, LRU eviction and
   preemption, and at tp 2 over gloo (int8 weights + int8 KV +
   speculative 3, the prefix cache's three cases, ``make_tp_generate``)
   against tp 1 (``tp2_f32_2l``);
5. holds the flash-attention kernels K1-K4 (forward, delta, dq, dk/dv)
   against their plain version through autograd -- bf16 and f32, head_dim
   64 and 128, causal and not, GQA, a ragged T, Tq != Tk, an lse
   cotangent, the 470m training shapes -- per tile of 64 rows, shows with
   planted faults (a skipped k-tile, a missing rescale, a p V product that
   misses its rescale, a dropped query head) that the limits would catch
   them, and times each kernel at the 470m and at the 470m-hd128
   training shapes beside its bound, its plain version and a library
   call, with K2 + K3 + K4 summed beside one SDPA backward;
6. trains the 470m GPT through kungfu_tpu_torch.benchmarks.gpt's code
   (--preset 470m: 64 x 2048 tokens a step in 32 microbatches, bf16
   compute, f32 AdamW masters), 1 warm-up and 2 timed steps, checking
   that every layer of every microbatch launched K1-K4; profiles one
   microbatch; and trains a full-width 2-layer f32 model for 2 steps with
   the kernels and with dense attention, which must agree;
7. holds K6 (the flash forward's tile loop with the softmax deleted)
   against its plain version at the roofline's four K6 shapes and ragged
   T, per tile of 64 rows, shows with a planted fault (every q-tile skips
   its last visible k-tile) that the limit would catch it, and times it
   beside its bound, its plain version and a library form;
8. runs the kernel roofline (kungfu_tpu_torch.benchmarks.roofline: the
   matmul and HBM ceilings, flash forward and forward+backward at head_dim
   64 and 128, K6, SDPA's forward) and reports K1 over K6 (the softmax's
   share of K1's time), flash over the matmul ceiling, and the measured
   ceilings beside the data-sheet ones that the bounds use;
9. trains the head_dim-128 470m (--preset 470m-hd128: 8 heads, 2 KV
   heads) for 1 warm-up and 2 timed steps, K1-K4 at every layer of every
   microbatch, and profiles one of its microbatches;
10. holds full-width ResNet-50 in f32 on the card against the same
   weights on the CPU (eval and train logits, the running statistics,
   one train step) and the bf16 model against the f32 one; trains it
   through kungfu_tpu_torch.benchmarks.resnet's code (bench.py's run:
   224 x 224, batch 256, bf16 over f32 parameters, sync-SGD nesterov, 5
   warm-up and 20 timed steps: images/s beside the V100 baseline, MFU,
   peak memory) and profiles one step; stages 4 full-size batches through
   the Prefetcher's pinned memory and side stream (bit-identical, in
   order, the H2D rate) and checks a step fed from it; and runs one
   forward and backward of BERT-base in bf16 against f32.  No hand
   kernel lies on this path (cuDNN convolutions, PyTorch ops), so the
   kernels record is that of phases 2-8;
11. runs the optimizer family (SMA, the noise-scale and variance
   monitors, adaptive SGD, pair averaging; no hand kernel either): on
   bert_tiny at 3 gloo ranks on the card against 3 on the CPU, with a
   reversed exchange and a dropped SMA pull planted in the workers
   (``optimizers_card_vs_cpu``); on BERT-base at full width in a world
   of one, each wrapper's step and ``optimizer.step()`` beside
   synchronous SGD's (``optimizers_bert_base_w1``); on BERT-base at 2
   ranks sharing the card over gloo, with the monitors' agreement and
   the replicas' spread gated (``optimizers_bert_base_2r``); and the
   README's convergence run, 8 ranks x 200 steps of
   ``kungfu_tpu_torch.examples.convergence_bert``, to its target
   (``convergence_bert``).
12. re-forms an NCCL group of one at versions 0, 1 and 2, each at a fresh
   FileStore, with an all-reduce and a tree broadcast at each, and
   ``memory_reserved`` and the card's used memory held to a margin
   (``elastic_nccl_reinit``); and
   trains the 470m GPT at full width, 6 of its 24 layers, while the
   port's config server and watcher resize it 2 -> 4 -> 3 (ranks sharing
   the card over gloo; rank 0 proposes each stage, the watcher spawns the
   newcomers and reaps the rank that leaves): the replicas and Adam
   moments bit for bit
   equal on every rank after each resize and at the end, the trained
   samples counted, the losses held to one process's over the same 9
   global batches; with planted faults (a newcomer that keeps its own
   weights, one that gets them but fresh Adam moments, a rank that takes
   its rows by the 4-rank block at 3 ranks, resumed from the run's
   checkpoint) each caught (``elastic_gpt_470m``);
13. trains the same model at 3 ranks sharing the card over gloo with a
   commit at every step, under the port's config server and watcher,
   and kills a rank: rank 2 inside its gradient
   all-reduce of step 3 (job A), rank 0 on its committer thread between
   the join and the publish of the commit of step 5 (job B); the watcher
   shrinks the cluster and the survivors re-form, restore the new rank
   0's commit and redo the step: one exclusion, the survivors at one
   version and size, replicas and Adam moments bit for bit equal after
   the recovery and at the end, the restored pair a published one, every
   step counted once, every loss within the limit of one process's over
   the same batches (6 steps in A, 7 in B), K1-K4 at every layer of
   every microbatch; job C (4 steps, beside B) plants a restore of the
   previous commit's state under the newest commit's counters, which the
   loss limit must catch; each recovery's
   timeline from the kill, the bytes the restore moved, the commits'
   dispatch and join, the steps/s at 3 and 2 ranks and every rank's peak
   memory (``elastic_recover_470m``);
14. trains the 470m GPT through ``parallel.threed.make_gpt_train_step``
   in 4 gloo ranks sharing the card: job A at (dp, sp, tp) = (1, 2, 2),
   full width and depth, ring-flash attention (K1-K4 on every chunk of
   every layer; the ring's chunk shapes are also FLASH_CASES y and z), 2
   sequences of 4096 tokens a step, one SGD step and two AdamW steps; job
   B at (2, 2, 1), 4 layers, Ulysses; each against one process with
   flash attention on the same weights, batch and optimizers: every
   rank's SGD gradient per tensor and every step's loss within their
   limits, K1-K4 launched exactly as the ring's schedule issues them,
   planted faults above the gradient limit (in A: no future mask in the
   ring-flash merge, replicated gradients summed over tp once more, RoPE
   without the sp offset; in B: the all-to-all joining its blocks in
   reverse rank order); step seconds, the collectives' share (each
   collective timed between two synchronizes) and bytes by kind, every
   rank's peak memory (``parallel_gpt_470m``);
15. trains the 470m GPT at full width and depth under
   ``parallel.fsdp`` in 2 gloo ranks sharing the card, one sequence of
   4096 tokens a rank, one SGD step and two AdamW steps, f32 master
   shards computed in bf16: job A layerwise ZeRO-3
   (``make_fsdp_scan_step``, a layer gathered at a time, remat, K1-K4 on
   every layer), B ZeRO-1 (``make_zero1_step``), C flat ZeRO-3
   (``make_fsdp_step``, its SGD step only); each against one process on
   the same weights, rows and optimizers: every step's loss and the SGD
   step's gradient per tensor within their limits, A's K1-K4 launches
   exactly as remat issues them, A's gathered parameter bytes alive at
   once at most one layer plus the embedding and head, A's peak below
   C's by the full parameters less one layer, B's replicas bit for bit
   on JAX's rule (the chunk plus its updates) and alike on both ranks;
   a rank's device memory after ``init`` (the caller's tree gone) its
   state and less than half a layer more; A's sharded checkpoint after
   step 2 restored by rank 0 alone into the n = 1 layout, bit for bit,
   then step 3: AdamW's step count restored, and the loss at the
   parameters step 3 leaves within the loss limit of A's; planted faults
   caught (a reduce-scatter without the mean, rank 1's gather in reverse
   rank order, ZeRO-1 gathering the new parameters in place of the
   updates); the step seconds, the collectives' seconds, share and bytes
   by kind, and every job's peak memory (``fsdp_gpt_470m``).

Each phase prints a JSON line.  The last two lines are the kernels record
and ``{"ok": true, "device": {...}}``.  Any failure exits non-zero; so
does a machine without a CUDA device.  Imports nothing of JAX.

``--parallel`` builds the kernels, prints the card, checks FLASH_CASES y
and z and runs only ``parallel_gpt_470m``.

``--fsdp`` builds the kernels, prints the card, checks FLASH_CASES y and
z and runs only ``fsdp_gpt_470m``.

``--serving-tp`` builds the kernels, prints the card, and runs only K5 at
the tp-2 shapes, ``serve_470m`` (tp 2's reference), ``serve_470m_tp2``
and ``tp2_f32_2l``.

``--commit-cost`` builds the kernels, prints the card, and runs only
``elastic_gpt_470m``'s sound schedule four times, with a commit at every
step, with none, none and at every step again: each job's step seconds
by cluster size (``elastic_commit_cost``).
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from kungfu_tpu_torch.benchmarks import flash_variants as FV
from kungfu_tpu_torch.benchmarks import gpt as BG
from kungfu_tpu_torch.benchmarks import resnet as BR
from kungfu_tpu_torch.benchmarks import roofline as RL
from kungfu_tpu_torch.benchmarks.timing import Timer
from kungfu_tpu_torch.comm.mesh import flat_mesh
from kungfu_tpu_torch.examples.ranks import launch
from kungfu_tpu_torch.models import gpt as G
from kungfu_tpu_torch.ops import _build
from kungfu_tpu_torch.ops import flash_attention as FA
from kungfu_tpu_torch.ops import paged_attention as PA
from kungfu_tpu_torch.ops.flash_attention import _expand_kv_heads
from kungfu_tpu_torch.ops.quant import (QuantizedTensor, dequantize_weights,
                                        quantize_weights)
from kungfu_tpu_torch.serving import DecodeEngine, Request, ServingServer
from kungfu_tpu_torch.serving import engine as E
from kungfu_tpu_torch.serving.cache import quantize_kv
from kungfu_tpu_torch.utils.tree import tree_leaves
from kungfu_tpu_torch.utils.device import resolve_device

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
F32_FLOPS = 67e12                # f32 outside the tensor cores

# the 470m preset (kungfu_tpu/benchmarks/gpt.py) served with the serving
# CLI's defaults: 8 slots, block 32, buckets 32/128/512, chunk 8
MODEL = dict(vocab_size=32768, d_model=1024, n_heads=16, n_kv_heads=4,
             n_layers=24, d_ff=4096, max_seq=1024, rope=True, mlp="swiglu")
ENGINE = dict(num_slots=8, block_size=32, num_blocks=512, max_len=1024,
              prompt_buckets=(32, 128, 512), decode_chunk=8)


START = time.perf_counter()


def emit(obj) -> None:
    """Print ``obj`` as a JSON line; a phase's line also carries the
    seconds since the script started (``elapsed_s``)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------- phase 2: K5
def k5_inputs(device, dtype, Q, quant, rng, S=8, H=16, KVH=4, Dh=64,
              bs=32, MB=32, N=512, full=False):
    """Ragged slots (positions 0 and 1023 included) with distinct blocks,
    zeros (scratch) beyond each slot's reach -- the engine's invariant.
    ``full``: every slot at the last position (max-length requests)."""
    pos = rng.randint(1, MB * bs - 1, S).astype(np.int32)
    pos[0], pos[1] = 0, MB * bs - 1
    if full:
        pos[:] = MB * bs - 1
    tables = np.zeros((S, MB), np.int32)
    free = list(range(1, N))
    rng.shuffle(free)
    for s in range(S):
        for b in range(min(MB, (pos[s] + Q - 1) // bs + 1)):
            tables[s, b] = free.pop()
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(device, dt)
    q = t(rng.randn(S, Q, H, Dh).astype(np.float32), dtype)
    kf = t(rng.randn(N, bs, KVH, Dh).astype(np.float32))
    vf = t(rng.randn(N, bs, KVH, Dh).astype(np.float32))
    if quant:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(dtype), vf.to(dtype), None, None
    return dict(q=q, k_pool=k, v_pool=v, tables=t(tables, torch.int32),
                pos=t(pos, torch.int32), k_scale=ks, v_scale=vs)


# K5's checked cases at the serving shapes: name -> (dtype, Q, int8 pool,
# tolerance).  bf16: p is rounded to bf16 before the PV product in the
# kernel (as in the TPU kernel), not in the plain version; f32: summation
# order only.
K5_CASES = {"a_bf16_q1": (torch.bfloat16, 1, False, 2e-2),
            "b_f32_q1": (torch.float32, 1, False, 1e-5),
            "c_bf16_q4": (torch.bfloat16, 4, False, 2e-2),
            "d_int8_q1": (torch.bfloat16, 1, True, 2e-2)}
K5_TOL = 2e-2                    # bf16
# K5's timed rows (bf16, seed 1): the serve's ragged slots, every slot at
# its last position (8.4 MB of K/V), the speculative verify (Q = 4)
K5_TIME_ROWS = {"a_bf16_q1": dict(Q=1), "f_bf16_q1_full": dict(Q=1,
                                                               full=True),
                "c_bf16_q4": dict(Q=4)}


def k5_time_inputs(device, name: str) -> dict:
    return k5_inputs(device, torch.bfloat16, quant=False,
                     rng=np.random.RandomState(1), **K5_TIME_ROWS[name])


def k5_excess(got, want, tol: float) -> float:
    """The largest |got - want| over tol + tol |want|: above 1 exactly
    where torch.testing.assert_close(rtol=tol, atol=tol) fails."""
    return ((got.float() - want.float()).abs()
            / (tol + tol * want.float().abs())).max().item()


def k5_bound(inp) -> dict:
    """Least time for the work these inputs need: each visited K/V block
    (and its scales) read once, q read and out written once; the score
    and PV products against the tensor-core (bf16) or f32 peak."""
    q, kp, tables, pos = inp["q"], inp["k_pool"], inp["tables"], inp["pos"]
    S, Q, H, Dh = q.shape
    bs, KVH = kp.shape[1], kp.shape[2]
    nb = torch.clamp((pos.long() + Q - 1) // bs + 1,
                     max=tables.shape[1]).sum().item()
    kv_bytes = 2 * nb * bs * KVH * Dh * kp.element_size()
    if inp["k_scale"] is not None:
        kv_bytes += 2 * nb * bs * KVH * 4
    io_bytes = 2 * q.numel() * q.element_size() + pos.numel() * 4 + nb * 4
    flops = 4 * nb * bs * Q * H * Dh
    peak = F32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": kv_bytes + io_bytes, "flops": flops}


def sdpa_yardstick(inp):
    """One PyTorch attention call on the gathered (an int8 pool
    dequantized), GQA-expanded cache with the same mask (gather
    included) -- a yardstick the port never calls."""
    q, kp, vp, tables, pos = (inp["q"], inp["k_pool"], inp["v_pool"],
                              inp["tables"], inp["pos"])
    S, Q, H, Dh = q.shape
    idx = tables.long()
    kc, vc = (p[idx].reshape(S, -1, kp.shape[2], Dh) for p in (kp, vp))
    if inp["k_scale"] is not None:
        kc, vc = ((c.float() * s[idx].reshape(S, -1, kp.shape[2], 1)
                   ).to(q.dtype) for c, s in ((kc, inp["k_scale"]),
                                              (vc, inp["v_scale"])))
    kc = _expand_kv_heads(kc, H // kp.shape[2])
    vc = _expand_kv_heads(vc, H // kp.shape[2])
    L = kc.shape[1]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= (pos.long()[:, None] + torch.arange(Q, device=q.device))
            [:, :, None])[:, None]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask).transpose(1, 2)


def _paged_split_plain(inp, ranks: int, fault=None):
    """K5 as the kernel splits it, in plain PyTorch: block b of a slot goes
    to part b % ``ranks``; each part keeps its own softmax state (m, l,
    acc; p rounded to q's dtype before the PV product) and the parts merge
    with weights exp(m_r - max m).  A planted ``fault``:
    "drop_newest_rank", the merge leaves out the part that holds the
    slot's newest keys; "unweighted", the parts are summed without their
    weights; "past_reach_scratch", the block after the slot's reach (its
    table entry: scratch block 0) is read as if every key were visible."""
    q, kp, vp, tables, pos = (inp["q"], inp["k_pool"], inp["v_pool"],
                              inp["tables"], inp["pos"])
    S, Q, H, Dh = q.shape
    bs, KVH, MB = kp.shape[1], kp.shape[2], tables.shape[1]
    idx = tables.long()
    kc, vc = (p[idx].reshape(S, MB * bs, KVH, Dh) for p in (kp, vp))
    if inp["k_scale"] is not None:
        kc = (kc.float() * inp["k_scale"][idx].reshape(S, -1, KVH, 1)
              ).to(q.dtype)
        vc = (vc.float() * inp["v_scale"][idx].reshape(S, -1, KVH, 1)
              ).to(q.dtype)
    kc, vc = (_expand_kv_heads(t, H // KVH).float() for t in (kc, vc))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc) / math.sqrt(Dh)
    kpos = torch.arange(MB * bs, device=q.device)
    reach = pos.long()[:, None] + torch.arange(Q, device=q.device)  # [S, Q]
    vis = (kpos[None, None, :] <= reach[:, :, None])[:, None]   # [S,1,Q,L]
    block = kpos // bs
    nb = torch.clamp((pos.long() + Q - 1) // bs + 1, max=MB)      # [S]
    if fault == "past_reach_scratch":
        vis = vis | (block[None, :] == nb[:, None])[:, None, None]
    part = block % ranks
    ms, ls, accs = [], [], []
    for r in range(ranks):
        keep = vis & (part == r)
        sr = torch.where(keep, s, PA.NEG_INF)
        m = sr.amax(dim=-1)
        p = torch.where(keep, torch.exp(sr - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhqk,bkhd->bhqd",
                                 p.to(q.dtype).float(), vc))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(dim=0))                     # [ranks, S, H, Q]
    if fault == "unweighted":
        w = torch.ones_like(w)
    elif fault == "drop_newest_rank":
        newest = (nb - 1) % ranks                                   # [S]
        w = w * (torch.arange(ranks, device=q.device)[:, None]
                 != newest[None, :]).float()[:, :, None, None]
    elif fault not in (None, "past_reach_scratch"):
        raise ValueError(f"unknown fault {fault!r}")
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0).clamp(
        min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)          # [S, Q, H, Dh]


K5_FAULTS = ("drop_newest_rank", "unweighted", "past_reach_scratch")
K5_RANKS = 8                     # the kernel's cluster width at MB = 32


def phase_kernel(device) -> dict:
    """K5 against its plain version: every K5_CASES case, and a poisoned
    scratch block 0 that the kernel must never read.  Returns case ->
    max abs error."""
    rng = np.random.RandomState(0)
    errs = {}
    for name, (dtype, Q, quant, tol) in K5_CASES.items():
        inp = k5_inputs(device, dtype, Q, quant, rng)
        got = PA.paged_attention_queries(**inp)
        want = PA.paged_attention_queries_ref(**inp)
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        errs[name] = err
        emit({"phase": "k5_check", "case": name, "max_abs_err": err,
              "tol": tol})
    # (e) scratch block 0 poisoned: the kernel must never read it
    inp = k5_inputs(device, torch.bfloat16, 1, False, rng)
    clean = PA.paged_attention_queries_ref(**inp)
    inp["k_pool"][0] = 1e3
    inp["v_pool"][0] = 1e3
    got = PA.paged_attention_queries(**inp)
    err = (got.float() - clean.float()).abs().max().item()
    torch.testing.assert_close(got.float(), clean.float(), rtol=K5_TOL,
                               atol=K5_TOL)
    emit({"phase": "k5_check", "case": "e_poisoned_scratch",
          "max_abs_err": err, "tol": K5_TOL})
    return errs


def phase_k5_faults(device) -> dict:
    """How far the K5 check's reading (k5_excess; above 1 fails) moves for
    a kernel with a planted fault, at the serve shapes: the split-and-merge
    emulation, sound and with each K5_FAULTS fault, against the plain
    version on the same inputs.  The sound one must read at most 1 and
    every fault above 1, or the check of phase_kernel could not see it."""
    inp = k5_time_inputs(device, "a_bf16_q1")
    want = PA.paged_attention_queries_ref(**inp)
    sound = k5_excess(_paged_split_plain(inp, K5_RANKS), want, K5_TOL)
    readings = {f: k5_excess(_paged_split_plain(inp, K5_RANKS, f), want,
                             K5_TOL) for f in K5_FAULTS}
    blind = {f: r for f, r in readings.items() if not r > 1}
    if blind or not sound <= 1:
        raise RuntimeError(f"K5 limit {K5_TOL} cannot see the faults {blind}"
                           f" (the sound split reads {sound})")
    return {"ranks": K5_RANKS, "tol": K5_TOL, "sound": sound,
            "readings": readings}


def phase_k5_time(device) -> dict:
    """K5 at each K5_TIME_ROWS row, checked against its plain version and
    timed beside its bound, the plain version and SDPA after a gather;
    and ``floor_ms``, one launch of a one-element fill through the same
    timer: the least time any single launch reads here.  Returns row ->
    record."""
    timer = Timer(device)
    one = torch.zeros(1, device=device)
    floor_ms = timer(lambda: one.fill_(1.0))
    recs = {}
    for name in K5_TIME_ROWS:
        inp = k5_time_inputs(device, name)
        got = PA.paged_attention_queries(**inp)
        want = PA.paged_attention_queries_ref(**inp)
        torch.testing.assert_close(got.float(), want.float(), rtol=K5_TOL,
                                   atol=K5_TOL)
        rec = {"ms": timer(lambda: PA.paged_attention_queries(**inp)),
               "plain_ms": timer(lambda: PA.paged_attention_queries_ref(
                   **inp)),
               "library_ms": timer(lambda: sdpa_yardstick(inp)),
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "library_err": (sdpa_yardstick(inp).float() - want.float()
                               ).abs().max().item(),
               "floor_ms": floor_ms, **k5_bound(inp)}
        emit({"phase": "k5_time", "case": name, **rec,
              "gb_per_s": rec["bytes"] / rec["ms"] / 1e6})
        recs[name] = rec
    return recs


# K5 at a tp-2 rank's shard of the 470m serve (8 query heads, 2 KV heads):
# row -> (Q, int8 pool); seed 1, the positions of K5_TIME_ROWS' rows
K5_TP2_ROWS = {"tp2_bf16_q1": (1, False), "tp2_bf16_q4": (4, False),
               "tp2_int8_q1": (1, True)}
K5_TP2_HEADS = dict(H=8, KVH=2)


def phase_k5_tp2(device) -> dict:
    """K5 at the tp-2 shard's shapes, q [8, Q, 8, 64] bf16 and pools
    [512, 32, 2, 64] bf16 or int8: checked against its plain version
    within ``K5_TOL``, and timed beside its bound, the plain version and
    SDPA after a gather (the int8 pool dequantized).  Returns row ->
    record."""
    timer = Timer(device)
    recs = {}
    for name, (Q, quant) in K5_TP2_ROWS.items():
        inp = k5_inputs(device, torch.bfloat16, Q, quant,
                        np.random.RandomState(1), **K5_TP2_HEADS)
        got = PA.paged_attention_queries(**inp)
        want = PA.paged_attention_queries_ref(**inp)
        torch.testing.assert_close(got.float(), want.float(), rtol=K5_TOL,
                                   atol=K5_TOL)
        rec = {"ms": timer(lambda: PA.paged_attention_queries(**inp)),
               "plain_ms": timer(lambda: PA.paged_attention_queries_ref(
                   **inp)),
               "library_ms": timer(lambda: sdpa_yardstick(inp)),
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "tol": K5_TOL, **k5_bound(inp)}
        emit({"phase": "k5_tp2", "case": name, **rec,
              "gb_per_s": rec["bytes"] / rec["ms"] / 1e6})
        recs[name] = rec
    return recs


# ------------------------------------------------------ phase 3: serve
def _stream(url, prompt, max_new):
    """POST a streamed /generate; returns (tokens, seconds to the first
    token line, done line)."""
    req = urllib.request.Request(
        url, data=json.dumps({"prompt": prompt, "max_new": max_new,
                              "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    ttft, toks, tail = None, [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            msg = json.loads(line)
            if "tokens" in msg:
                ttft = ttft or time.perf_counter() - t0
                toks += msg["tokens"]
            else:
                tail = msg
    return toks, ttft, tail


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def drive_traffic(base, prompts, max_new, warmup, zero) -> dict:
    """Stream ``warmup`` (2 tokens), call ``zero()``, then stream
    ``prompts`` from concurrent clients, ``max_new`` tokens each, to the
    server at ``base``; read ``GET /stats`` and ``GET /requests?n=64``
    after.  Returns the replies, the clients' wall seconds, both reads
    and ``zero()``'s value."""
    url = base + "/generate"
    warm = _stream(url, warmup, 2)
    results = [None] * len(prompts)

    def client(i):
        results[i] = _stream(url, prompts[i], max_new)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    before = zero()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    return {"warm": warm, "results": results,
            "wall": time.perf_counter() - t0, "before": before,
            "stats": _get(base + "/stats"),
            "journal": _get(base + "/requests?n=64")}


def check_traffic(run, max_new, vocab_size) -> dict:
    """The gates of a :func:`drive_traffic` run: every request returns
    ``max_new`` in-range tokens; ``GET /requests`` holds one finished
    record per request, warm-up included, each with ttft <= e2e.
    Returns the client-side readings."""
    results, journal = run["results"], run["journal"]
    for i, res in enumerate(results):
        if res is None:
            raise RuntimeError(f"request {i} got no reply")
        toks, _, tail = res
        if (len(toks) != max_new or not tail or not tail.get("done")
                or tail.get("tokens_total") != max_new):
            raise RuntimeError(f"request {i}: {len(toks)} tokens, {tail}")
        if not all(0 <= t < vocab_size for t in toks):
            raise RuntimeError(f"request {i}: token out of range")
    uids = {run["warm"][2]["uid"]} | {r[2]["uid"] for r in results}
    fin = {rec["uid"]: rec for rec in journal["finished"]}
    if set(fin) != uids or journal["open"] or any(
            rec["outcome"] != "finish" or rec["ttft_ms"] is None
            or rec["ttft_ms"] > rec["e2e_ms"] for rec in fin.values()):
        raise RuntimeError(f"journal: finished {sorted(fin)} for requests "
                           f"{sorted(uids)}, open {journal['open']}")
    n_req, wall = len(results), run["wall"]
    return {"requests": n_req, "max_new": max_new, "wall_s": wall,
            "tokens_per_s": n_req * max_new / wall,
            "mean_ttft_s": statistics.mean(r[1] for r in results),
            "journal_mean_ttft_s": statistics.mean(
                fin[r[2]["uid"]]["ttft_ms"] for r in results) / 1e3,
            "journal_records": len(fin), "slo": journal["slo"],
            "tokens": [r[0] for r in results]}


def serve_traffic(eng, prompts, max_new, warmup) -> dict:
    """Serve ``warmup`` then ``prompts`` (16 concurrent streamed clients)
    through a ServingServer on ``eng``; K5 launches and the engine's
    stats count the clients' run only.  Gates: those of
    :func:`check_traffic`, and K5 launched at least layers x dispatches x
    chunk times."""
    srv = ServingServer(eng, port=0).start()

    def zero():
        eng.stats.reset()
        PA.launches = 0           # counts from the main path's run only

    try:
        run = drive_traffic(f"http://{srv.host}:{srv.port}", prompts,
                            max_new, warmup, zero)
        launches = PA.launches
    finally:
        srv.close()
    cfg, stats = eng.cfg, run["stats"]
    out = check_traffic(run, max_new, cfg.vocab_size)
    need = cfg.n_layers * stats["dispatches"] * eng.K
    if launches < need or launches == 0:
        raise RuntimeError(f"K5 launched {launches} times, decode needed "
                           f"{need} ({cfg.n_layers} layers x "
                           f"{stats['dispatches']} dispatches x chunk "
                           f"{eng.K})")
    return dict(out, k5_launches=launches, k5_launches_needed=need,
                weight_bytes=E.resident_bytes(eng.params), stats=stats)


def serve_prompts(cfg, n_req=16, plen=(8, 500)):
    """The serve traffic's prompts: ``RandomState(2)``, 8-500 tokens."""
    rng = np.random.RandomState(2)
    return [rng.randint(0, cfg.vocab_size, int(rng.randint(*plen))).tolist()
            for _ in range(n_req)]


def phase_serve(params, cfg, device, max_new=64, **kw) -> dict:
    """The 470m engine (``ENGINE``, ``kw`` on top) serving the serve
    traffic over HTTP."""
    eng = DecodeEngine(params, cfg, device=device, **dict(ENGINE, **kw))
    return serve_traffic(eng, serve_prompts(cfg), max_new, [1, 2, 3])


def phase_serve_int8w(params, cfg, device, bf16_bytes: int) -> dict:
    """The serve traffic on ``weights_int8``.  Gates: the served engine,
    run again on the same 16 requests, gives the tokens of a plain engine
    on ``dequantize_weights(quantize_weights(params), bf16)`` (the same
    weight bits and the same batches: equal by construction), and the
    weight tree takes at most 0.6x the bf16 engine's bytes."""
    eng = DecodeEngine(params, cfg, device=device, weights_int8=True,
                       **ENGINE)
    out = serve_traffic(eng, serve_prompts(cfg), 64, [1, 2, 3])
    served = out.pop("tokens")
    reqs = [dict(uid=i, prompt=p, max_new=64)
            for i, p in enumerate(serve_prompts(cfg))]
    got = eng.run([Request(**r) for r in reqs])
    del eng
    oracle = dequantize_weights(quantize_weights(params), cfg.dtype)
    want = DecodeEngine(oracle, cfg, device=device, **ENGINE).run(
        [Request(**r) for r in reqs])
    del oracle
    if got != want:
        bad = [u for u in want if got.get(u) != want[u]]
        raise RuntimeError(f"int8 engine differs from its dequantized "
                           f"oracle on requests {bad}")
    ratio = out["weight_bytes"] / bf16_bytes
    if ratio > 0.6:
        raise RuntimeError(f"int8 weights take {ratio:.3f}x the bf16 "
                           f"engine's bytes (limit 0.6)")
    return dict(out, oracle_tokens_equal=True, bf16_weight_bytes=bf16_bytes,
                weight_bytes_ratio=ratio,
                served_equal_offline=sum(served[i] == got[i]
                                         for i in range(len(served))))


def phase_profile(params, cfg, device, chunks=2, **kw) -> dict:
    """Where a decode chunk's time goes: the 470m engine (``kw`` on top of
    ``ENGINE``) with all 8 slots decoding (prompts of 256), ``chunks``
    steady-state chunks under torch.profiler.  Device busy share = summed
    kernel time / wall time (one stream, so kernels do not overlap); the
    rest is the card waiting on the host."""
    from torch.profiler import ProfilerActivity, profile
    eng = DecodeEngine(params, cfg, device=device, **dict(ENGINE, **kw))
    rng = np.random.RandomState(6)
    for i in range(eng.S):
        eng.submit(Request(uid=i, prompt=rng.randint(
            0, cfg.vocab_size, 256).tolist(), max_new=eng.K * (chunks + 3)))
    eng.step()                                       # prefill + warm-up
    eng.step()
    torch.cuda.synchronize()
    calls = PA.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = PA.launches - calls
    from torch.autograd import DeviceType
    device_rows = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
    kernels = {ev.key: ev.self_device_time_total for ev in device_rows}
    busy_us = sum(kernels.values())
    k5_us = sum(v for k, v in kernels.items() if "paged_attention" in k)
    k5_kernels = sum(ev.count for ev in device_rows
                     if "paged_attention" in ev.key)
    # one K5 kernel per wrapper call (a decode layer-step), no second pass
    if k5_kernels != calls or calls == 0:
        raise RuntimeError(f"profile: {k5_kernels} paged_attention kernels "
                           f"for {calls} wrapper calls")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"chunks": chunks, "chunk_steps": eng.K,
            "wall_ms_per_chunk": wall * 1e3 / chunks,
            "device_busy_ms_per_chunk": busy_us / 1e3 / chunks,
            "device_busy_share": busy_us / 1e6 / wall,
            "k5_ms_per_chunk": k5_us / 1e3 / chunks,
            "k5_kernels_per_chunk": k5_kernels / chunks,
            "k5_calls_per_chunk": calls / chunks,
            "launches_per_chunk": sum(ev.count for ev in device_rows)
            / chunks,
            "top_kernels_ms_per_chunk": [[k[:80], v / 1e3 / chunks]
                                         for k, v in top]}


def phase_variant(params, cfg, device, name, n_req=4, max_new=32,
                  plen=(8, 200), **kw) -> dict:
    """A reduced-depth engine variant serving the same 4 requests."""
    eng = DecodeEngine(params, cfg, device=device,
                       **dict(ENGINE, **kw))
    rng = np.random.RandomState(3)
    reqs = [Request(uid=i, prompt=(rng.randint(0, 64, 6).tolist() * 40)
                    [:int(rng.randint(*plen))], max_new=max_new)
            for i in range(n_req)]
    before = PA.launches
    out = eng.run(reqs)
    launched = PA.launches - before
    if sorted(out) != list(range(n_req)) or any(
            len(t) != max_new for t in out.values()):
        raise RuntimeError(f"{name}: incomplete results")
    if launched < cfg.n_layers * eng.stats.dispatches:
        raise RuntimeError(f"{name}: K5 launched {launched} times")
    return {"variant": name, "k5_launches": launched,
            "stats": eng.stats.summary()}


def phase_fused_vs_gather(device, lengths=(5, 40, 130, 300)) -> dict:
    cfg = G.GPTConfig(**dict(MODEL, n_layers=2), dtype=torch.float32)
    params = G.init_params(torch.Generator(device=device).manual_seed(4),
                           cfg)
    rng = np.random.RandomState(5)
    reqs = [dict(uid=i, prompt=rng.randint(0, cfg.vocab_size, n).tolist(),
                 max_new=16) for i, n in enumerate(lengths)]
    out = {}
    for attend in ("fused", "gather"):
        eng = DecodeEngine(params, cfg, device=device, attend=attend,
                           **ENGINE)
        out[attend] = eng.run([Request(**r) for r in reqs])
    if out["fused"] != out["gather"]:
        raise RuntimeError(f"fused {out['fused']} != gather "
                           f"{out['gather']}")
    return {"requests": len(reqs), "tokens_equal": True}


def _prefix_requests(prefix, n, max_new, bs):
    """``n`` requests: ``prefix`` then two tokens of their own (as
    tests/test_prefix_cache.py's, at this block size)."""
    return [dict(uid=i, prompt=prefix + [10 + i, 20 + i], max_new=max_new)
            for i in range(n)]


def prefix_cases(cfg) -> dict:
    """tests/test_prefix_cache.py's cases at 32-token blocks (its prompts
    and lengths times 8): name -> (engine settings over ``ENGINE``,
    request batches run one after the other).  A roomy pool; LRU
    eviction (1 slot, 7 blocks, prompts A B B A); preemption (16
    blocks)."""
    bs = ENGINE["block_size"]
    rng = np.random.RandomState(8)
    prefix = rng.randint(0, cfg.vocab_size, 4 * bs).tolist()
    a = rng.randint(0, cfg.vocab_size, 4 * bs + 1).tolist()
    b = rng.randint(0, cfg.vocab_size, 4 * bs + 1).tolist()
    return {
        "roomy": (dict(num_slots=4, num_blocks=512),
                  [_prefix_requests(prefix, 4, 48, bs)]),
        "eviction": (dict(num_slots=1, num_blocks=8),
                     [[dict(uid=i, prompt=p, max_new=3)]
                      for i, p in enumerate((a, b, b, a))]),
        "preemption": (dict(num_slots=4, num_blocks=16),
                       [_prefix_requests(prefix, 5, 64, bs)]),
    }


def prefix_gate(name: str, st) -> dict:
    """The cache-on engine's stats after :func:`prefix_cases` case
    ``name``: the cache hit (roomy), the evicted repeat missed
    (eviction), preemption happened (preemption)."""
    bs = ENGINE["block_size"]
    ok = {"roomy": st.prefix_hits == 3
          and st.prefix_tokens_reused == 3 * 4 * bs,
          "eviction": st.prefix_hits == 1
          and st.prefix_tokens_reused == 4 * bs,
          "preemption": st.preemptions >= 1 and st.prefix_hits >= 1}
    if not ok[name]:
        raise RuntimeError(f"prefix {name}: {st.summary()}")
    return {k: getattr(st, k) for k in (
        "prefix_hits", "prefix_tokens_reused", "preemptions", "prefills")}


def phase_prefix_f32(device) -> dict:
    """tests/test_prefix_cache.py's cases on the card (:func:`prefix_cases`):
    a full-width 2-layer f32 engine, ``prefill_group=1``.  Gates: greedy
    tokens equal the cache-off engine's in each case; :func:`prefix_gate`;
    every reference count returns to zero."""
    cfg = G.GPTConfig(**dict(MODEL, n_layers=2), dtype=torch.float32)
    params = G.init_params(torch.Generator(device=device).manual_seed(7),
                           cfg)
    out = {}
    for name, (kw, batches) in prefix_cases(cfg).items():
        kw = dict(ENGINE, prefill_group=1, **kw)
        on = DecodeEngine(params, cfg, device=device, prefix_cache=True,
                          **kw)
        off = DecodeEngine(params, cfg, device=device, **kw)
        for reqs in batches:
            got = on.run([Request(**r) for r in reqs])
            want = off.run([Request(**r) for r in reqs])
            if got != want:
                raise RuntimeError(f"prefix {name}: tokens {got} != cache "
                                   f"off {want}")
        if int((on._block_ref > 0).sum()) or (on._available()
                                              != on._total_blocks):
            raise RuntimeError(f"prefix {name}: references left")
        out[name] = prefix_gate(name, on.stats)
    return {"cases": out, "tokens_equal": True}


PREFIX_SYSTEM = 384              # tokens of the shared system prompt
PREFIX_TOL = 5e-2                # max |cached - full| / max |full| logit


def prefix_prompts(cfg, n_req=16):
    """A seeded 384-token system prompt, a warm-up request carrying it,
    and ``n_req`` prompts of it plus 8-100 seeded tokens of their own."""
    rng = np.random.RandomState(9)
    system = rng.randint(0, cfg.vocab_size, PREFIX_SYSTEM).tolist()
    warm = system + rng.randint(0, cfg.vocab_size, 8).tolist()
    return warm, [system + rng.randint(0, cfg.vocab_size,
                                       int(rng.randint(8, 101))).tolist()
                  for _ in range(n_req)]


def _prefix_logits(eng, prompts, shared, t_cached, fault=None):
    """Last-position f32 logits [n, V] of ``prompts`` through the engine's
    own prefill functions on fresh blocks: the suffix prefill over the
    cached ``shared`` blocks (``t_cached`` tokens), or with ``shared``
    None the full-prompt prefill.  ``fault``: "short" passes t_cached one
    block short; "block" points one shared column at the scratch block.
    Returns (logits, ms of the program, synchronised).  On a tp engine
    every rank makes the same call (the programs' collectives pair up)
    and gets the same logits."""
    bs, n = eng.bs, len(prompts)
    for blk in shared or []:           # no eviction may take them
        eng._acquire_shared(blk)
    own = [eng._alloc(-(-len(p) // bs) - len(shared or [])) for p in prompts]
    rows = np.zeros((n, eng.max_blocks), np.int32)
    tc = t_cached if shared is not None else 0
    T = eng._bucket(max(len(p) for p in prompts) - tc)
    toks = np.zeros((n, T), np.int32)
    t_real = np.zeros(n, np.int32)
    for g, p in enumerate(prompts):
        blocks = (shared or []) + own[g]
        rows[g, :len(blocks)] = blocks
        toks[g, :len(p) - tc] = p[tc:]
        t_real[g] = len(p) - tc
    if fault == "block":
        rows[:, 3] = 0
    if fault == "short":
        tc -= bs
    dev = eng._dev
    prep = E._weights_at_use(eng.cfg, eng.weights_int8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        if shared is None:
            x = E._prefill_features(eng.params, eng.cfg, bs, eng.pools,
                                    dev(rows), dev(toks), dev(t_real), prep,
                                    eng.tp)
        else:
            x = E._prefill_cached_features(
                eng.params, eng.cfg, bs, eng.pools, dev(rows), dev(toks),
                dev(t_real), dev(np.full(n, tc, np.int32)), prep, eng.tp)
        logits = E._last_logits(eng.params, x, dev(t_real), prep, eng.tp)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    for blk in [b for blocks in own for b in blocks] + (shared or []):
        eng._release_block(blk)
    return logits, ms


def phase_serve_prefix(params, cfg, device) -> dict:
    """The 470m engine with ``prefix_cache`` serving 16 streamed requests
    that share a 384-token system prompt (12 blocks), after one warm-up
    request carrying it seeds the cache; the same traffic with the cache
    off, in turns (on, off, off, on), since the admission grouping of 16
    concurrent arrivals moves tokens/s and TTFT from run to run.  Gates,
    on every cache-on run: 16 hits reusing 16 x 384 tokens; K5 (over
    aliased block tables) and the journal as in ``serve_traffic``.  On
    the first: the suffix prefill's last-position logits, read through
    the shared blocks, against a full-prompt prefill of the same 8
    prompts, within ``PREFIX_TOL`` of max |logit|, while two planted
    faults (t_cached one block short; a shared block read from scratch)
    read above it.  Greedy tokens on against off are counted, not gated:
    in bf16 the two programs sum in different orders and a near-tie
    argmax may flip."""
    warm, prompts = prefix_prompts(cfg)
    runs, tokens, check = [], {}, None
    for mode in ("on", "off", "off", "on"):
        eng = DecodeEngine(params, cfg, device=device,
                           prefix_cache=mode == "on", **ENGINE)
        out = serve_traffic(eng, prompts, 64, warm)
        tokens.setdefault(mode, out.pop("tokens"))
        st = out["stats"]
        if mode == "on" and (st.get("prefix_hits") != len(prompts)
                             or st.get("prefix_tokens_reused")
                             != len(prompts) * PREFIX_SYSTEM):
            raise RuntimeError(f"prefix cache: {st}")
        runs.append(dict({k: out[k] for k in (
            "tokens_per_s", "mean_ttft_s", "journal_mean_ttft_s",
            "k5_launches")}, mode=mode, **{k: st[k] for k in (
                "dispatches", "prefills", "occupancy")}))
        if mode == "on" and check is None:
            check = prefix_check(eng, prompts)
        del eng
    return dict(check, system_tokens=PREFIX_SYSTEM, logit_limit=PREFIX_TOL,
                tokens_equal_on_off=sum(a == b for a, b in zip(
                    tokens["on"], tokens["off"])), runs=runs,
                near_ties=near_ties(params, cfg, device, prompts,
                                    tokens["on"], tokens["off"]))


def near_ties(params, cfg, device, prompts, on, off,
              names=("on", "off")) -> list:
    """For each request whose greedy tokens differ between two runs
    (``on`` and ``off``, named ``names``): the first index where they
    differ and the f32 logit margin there, from a full prefill by a
    one-device engine of the prompt and the tokens both runs agree on:
    ``margin`` = logit[off's token] - logit[on's token], ``top2`` = the
    gap between the two largest logits, and both over max |logit|
    (``margin_rel``), to set beside bf16's rounding (2^-8 = 0.0039)."""
    eng = DecodeEngine(params, cfg, device=device,
                       **dict(ENGINE, prompt_buckets=(32, 128, 512, 1024)))
    out = []
    for uid, (a, b) in enumerate(zip(on, off)):
        if a == b:
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if i >= min(len(a), len(b)):
            out.append({"uid": uid, "index": i, "lengths": [len(a), len(b)]})
            continue
        logits, _ = _prefix_logits(eng, [prompts[uid] + a[:i]], None, 0)
        row = logits[0].float()
        top = row.topk(2).values
        scale = row.abs().max().item()
        margin = (row[b[i]] - row[a[i]]).item()
        out.append({"uid": uid, "index": i, f"token_{names[0]}": a[i],
                    f"token_{names[1]}": b[i], "margin": margin,
                    "top2": (top[0] - top[1]).item(), "max_abs_logit": scale,
                    "margin_rel": abs(margin) / scale})
    del eng
    return out


def prefix_check(eng, prompts) -> dict:
    """The logit gate of ``phase_serve_prefix`` on a cache-on engine that
    has served the traffic, and the two prefill programs' wall times."""
    # the system prompt's 12 blocks (a prompt's own full blocks are
    # cached too, so the probe may reach further)
    shared, tc = eng._probe_prefix(Request(uid=-1, prompt=prompts[0],
                                           max_new=1))
    if tc < PREFIX_SYSTEM:
        raise RuntimeError(f"the cache lost the system prompt: {tc} tokens")
    tc = PREFIX_SYSTEM
    shared = shared[:tc // eng.bs]
    group = prompts[:eng.G]
    full, full_ms = _prefix_logits(eng, group, None, 0)
    cached, cached_ms = _prefix_logits(eng, group, shared, tc)
    scale = full.abs().max().item()
    err = {"sound": (cached - full).abs().max().item() / scale}
    for fault in ("block", "short"):               # "short" writes last
        bad, _ = _prefix_logits(eng, group, shared, tc, fault)
        err[fault] = (bad - full).abs().max().item() / scale
    if err["sound"] > PREFIX_TOL or min(err["block"],
                                        err["short"]) <= PREFIX_TOL:
        raise RuntimeError(f"prefix logits: {err} against the limit "
                           f"{PREFIX_TOL}")
    return {"logit_err": err, "group": len(group),
            "suffix_prefill_ms": cached_ms, "full_prefill_ms": full_ms}

# ------------------------------------------- tensor-parallel serving (tp 2)
# the tp-2 engine's prefill logits on rank 0 against the tp-1 engine's, max
# |tp2 - tp1| / max |tp1| (set before the first run on the card)
TP_LOGIT_TOL = 5e-2
# where tp 2's greedy tokens part from tp 1's: the tp-1 logit margin
# between the two tokens over max |logit| above this fails (bf16 rounds at
# 2^-8 = 0.0039 relative)
TP_TIE_LIMIT = 2e-2
TP_FAULTS = ("attn_psum_skipped", "kv_shard_of_rank0",
             "vocab_gather_reversed")
TP_BUDGET_S = 600.0
TP_F32_SEED = 11


def serve_argv(tp: int) -> list:
    """The serving CLI's command for ``MODEL`` under ``ENGINE`` with seed 0
    (main's weights) on a free port; ``tp`` ranks over gloo (sharing the
    card) unless 0."""
    m, e = MODEL, ENGINE
    argv = [sys.executable, "-m", "kungfu_tpu_torch.serving",
            "--vocab", m["vocab_size"], "--d-model", m["d_model"],
            "--n-heads", m["n_heads"], "--n-kv-heads", m["n_kv_heads"],
            "--n-layers", m["n_layers"], "--d-ff", m["d_ff"],
            "--max-seq", m["max_seq"], "--rope", "--swiglu", "--seed", 0,
            "--slots", e["num_slots"], "--block", e["block_size"],
            "--blocks", e["num_blocks"], "--max-len", e["max_len"],
            "--chunk", e["decode_chunk"],
            "--buckets", ",".join(map(str, e["prompt_buckets"])),
            "--port", 0]
    if tp:
        argv += ["--tp", tp, "--backend", "gloo"]
    return [str(a) for a in argv]


@contextlib.contextmanager
def cli_server(argv, log_path: str, timeout: float = TP_BUDGET_S):
    """The serving CLI ``argv`` as a process in a session of its own
    (stderr to ``log_path``): yields its base URL once it prints its
    readiness line.  On the way out it gets SIGTERM and must exit 0
    within 120 s; its process group is killed whatever happens."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, cwd=here,
                                env=dict(os.environ, PYTHONPATH=here),
                                stdout=subprocess.PIPE, stderr=log,
                                text=True, start_new_session=True)

    def tail():
        with open(log_path) as f:
            return f.read()[-3000:]
    try:
        line = []
        reader = threading.Thread(
            target=lambda: line.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout)
        if not line or not line[0].startswith("SERVING ready on"):
            raise RuntimeError(f"the serving CLI did not start: {line}\n"
                               f"{tail()}")
        yield "http://" + line[0].split()[-1]
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=120) != 0:
            raise RuntimeError(f"the serving CLI exited {proc.returncode}"
                               f"\n{tail()}")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


@contextlib.contextmanager
def tp_fault(fault, eng, full):
    """A fault planted in this tp rank for the block: "attn_psum_skipped",
    layer 0's attention-output all-reduce is skipped; "kv_shard_of_rank0",
    rank 1 holds rank 0's KV-head shard of wk and wv; "vocab_gather_
    reversed", the vocabulary blocks of the logits join in reverse rank
    order.  ``full``: the unsharded parameter tree."""
    finish, gather = G._decode_finish, G._tp_gather
    saved = [(layer["wk"], layer["wv"]) for layer in eng.params["layers"]]
    if fault == "attn_psum_skipped":
        calls = [0]

        def finish_(layer, x, o, cfg, psum=None):
            calls[0] += 1
            if (calls[0] - 1) % cfg.n_layers or psum is None:
                return finish(layer, x, o, cfg, psum)
            skip = [True]              # the attention output's psum

            def psum_(t):
                if skip:
                    skip.pop()
                    return t
                return psum(t)
            return finish(layer, x, o, cfg, psum_)
        G._decode_finish = finish_
    elif fault == "kv_shard_of_rank0":
        if eng.rank == 1:
            for layer, src in zip(eng.params["layers"], full["layers"]):
                for k in ("wk", "wv"):
                    layer[k] = src[k].chunk(2, dim=1)[0].to(
                        eng.cfg.dtype).contiguous()
    elif fault == "vocab_gather_reversed":
        def gather_(t, group):
            parts = gather(t, group).chunk(dist.get_world_size(group), -1)
            return torch.cat(parts[::-1], dim=-1)
        G._tp_gather = gather_
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        G._decode_finish, G._tp_gather = finish, gather
        for layer, (k, v) in zip(eng.params["layers"], saved):
            layer["wk"], layer["wv"] = k, v


def tp_logits_worker(rank: int, world: int, tmp: str) -> None:
    """One rank of ``tp_logit_check``: the 470m engine at tp ``world`` over
    gloo on the card (main's seed-0 weights, ``ENGINE``); the prefill
    logits of the serve traffic's first 8 prompts, sound and with each of
    ``TP_FAULTS`` planted; rank 0 saves them."""
    from kungfu_tpu_torch.comm.mesh import serving_mesh
    device = _join(rank, world, tmp)
    cfg = G.GPTConfig(**MODEL, dtype=torch.bfloat16)
    full = G.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    eng = DecodeEngine(full, cfg, device=device, mesh=serving_mesh(world),
                       **ENGINE)
    prompts = serve_prompts(cfg)[:ENGINE["num_slots"]]
    out = {}
    for fault in (None,) + TP_FAULTS:
        with tp_fault(fault, eng, full):
            out[fault or "sound"] = _prefix_logits(eng, prompts, None,
                                                   0)[0].cpu()
    if rank == 0:
        torch.save(out, os.path.join(tmp, "logits.pt"))
    dist.destroy_process_group()


def tp_logit_check(params, cfg, device, tmp: str) -> dict:
    """Rank 0's prefill logits at tp 2 (:func:`tp_logits_worker`) against
    the tp-1 engine's on the same prompts and blocks: the sound run within
    ``TP_LOGIT_TOL`` of max |logit|, each planted fault above it."""
    _spawn([_worker_argv("tp_logits_worker", r, 2, tmp) for r in range(2)],
           TP_BUDGET_S, tmp)
    got = torch.load(os.path.join(tmp, "logits.pt"))
    eng = DecodeEngine(params, cfg, device=device, **ENGINE)
    want = _prefix_logits(eng, serve_prompts(cfg)[:ENGINE["num_slots"]],
                          None, 0)[0].float().cpu()
    del eng
    scale = want.abs().max().item()
    err = {k: (v.float() - want).abs().max().item() / scale
           for k, v in got.items()}
    if err["sound"] > TP_LOGIT_TOL or min(err[f] for f in TP_FAULTS) \
            <= TP_LOGIT_TOL:
        raise RuntimeError(f"tp-2 prefill logits: {err} against the limit "
                           f"{TP_LOGIT_TOL}")
    return {"logit_err": err, "limit": TP_LOGIT_TOL, "rows": len(want)}


def phase_serve_470m_tp2(params, cfg, device, tp1: dict) -> dict:
    """The 470m served at tp 2 through ``python -m kungfu_tpu_torch.serving
    --tp 2 --backend gloo`` (2 ranks sharing the card, ``ENGINE``, seed 0:
    ``serve_470m``'s weights) to ``serve_470m``'s 16 streamed requests.
    ``tp1``: serve_470m's record (its tokens and weight bytes).

    Counts are read from ``GET /stats`` before the clients start and
    after they finish (each rank's counters ride in the token check).
    Gates: :func:`check_traffic`'s; on each rank, K5 launched exactly
    layers x chunk x decode dispatches times; rank 0's prefill logits
    against tp 1's (:func:`tp_logit_check`, three planted faults above
    its limit); where a request's greedy tokens part from tp 1's, the
    tp-1 margin there within ``TP_TIE_LIMIT``."""
    prompts = serve_prompts(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        with cli_server(serve_argv(2), os.path.join(tmp, "cli.log")) as base:
            run = drive_traffic(base, prompts, 64, [1, 2, 3],
                                lambda: _get(base + "/stats"))
        out = check_traffic(run, 64, cfg.vocab_size)
        check = tp_logit_check(params, cfg, device, tmp)
    tokens = out.pop("tokens")
    before, after = run["before"], run["stats"]
    dispatches = after["dispatches"] - before["dispatches"]
    prefills = after["prefills"] - before["prefills"]
    need = cfg.n_layers * ENGINE["decode_chunk"] * dispatches
    V, D = cfg.vocab_size, cfg.d_model
    # f32 wte, lnf and lm_head: whole on tp 1; the rank's half of lm_head
    rest1, rest2 = (2 * V * D + D) * 4, (V * D + V * D // 2 + D) * 4
    ranks = []
    for r, (b, a) in enumerate(zip(before["tp_ranks"], after["tp_ranks"])):
        k5 = a["k5_launches"] - b["k5_launches"]
        if k5 != need or k5 == 0:
            raise RuntimeError(f"rank {r}: K5 launched {k5} times, decode "
                               f"needed {need} ({cfg.n_layers} layers x "
                               f"{dispatches} dispatches x chunk "
                               f"{ENGINE['decode_chunk']})")
        coll = a["collective_s"] - b["collective_s"]
        ranks.append({
            "rank": r, "k5_launches": int(k5), "k5_launches_needed": need,
            "collective_s": coll,
            "collective_s_per_program": coll / (dispatches + prefills),
            "weight_bytes": int(a["weight_bytes"]),
            "layer_bytes_vs_tp1": (a["weight_bytes"] - rest2)
            / (tp1["weight_bytes"] - rest1),
            "peak_gb": a["peak_bytes"] / 1e9})
    ties = near_ties(params, cfg, device, prompts, tokens, tp1["tokens"],
                     names=("tp2", "tp1"))
    wide = [t for t in ties if not t.get("margin_rel", 1.0) <= TP_TIE_LIMIT]
    if wide:
        raise RuntimeError(f"tp 2 parts from tp 1 where tp 1's margin is "
                           f"above {TP_TIE_LIMIT}: {wide}")
    return dict(out, dispatches=dispatches, prefills=prefills, ranks=ranks,
                logit_check=check, tp1_tokens_per_s=tp1["tokens_per_s"],
                tp1_mean_ttft_s=tp1["mean_ttft_s"],
                tp1_weight_bytes=tp1["weight_bytes"],
                tokens_equal_tp1=sum(a == b for a, b in zip(
                    tokens, tp1["tokens"])), near_ties=ties,
                tie_limit=TP_TIE_LIMIT)


def tp_f32_cases(cfg) -> dict:
    """``tp2_f32_2l``'s engine runs: name -> (settings over ``ENGINE``,
    request batches): int8 weights + int8 KV + speculative 3 on
    ``phase_variant``'s repetitive prompts, and :func:`prefix_cases`
    with the cache on."""
    rng = np.random.RandomState(3)
    spec = [dict(uid=i, prompt=(rng.randint(0, 64, 6).tolist() * 40)
                 [:int(rng.randint(8, 200))], max_new=32) for i in range(4)]
    cases = {"int8w_kvint8_spec3": (dict(weights_int8=True,
                                         kv_dtype=torch.int8,
                                         speculative=3), [spec])}
    for name, (kw, batches) in prefix_cases(cfg).items():
        cases[f"prefix_{name}"] = (dict(kw, prefix_cache=True,
                                        prefill_group=1), batches)
    return cases


def tp_f32_prompt(cfg):
    return np.random.RandomState(12).randint(0, cfg.vocab_size, (2, 16))


def tp_f32_model(device):
    cfg = G.GPTConfig(**dict(MODEL, n_layers=2), dtype=torch.float32)
    return cfg, G.init_params(
        torch.Generator(device=device).manual_seed(TP_F32_SEED), cfg)


def run_batches(eng, batches) -> dict:
    out = {}
    for reqs in batches:
        out.update({str(u): t for u, t in eng.run(
            [Request(**r) for r in reqs]).items()})
    return out


def tp_f32_worker(rank: int, world: int, tmp: str) -> None:
    """One rank of ``tp2_f32_2l``: each :func:`tp_f32_cases` engine at tp
    ``world`` over gloo on the card, and ``make_tp_generate``; rank 0
    saves the tokens, the stats and each rank's K5 launches."""
    from kungfu_tpu_torch.comm.mesh import serving_mesh
    from kungfu_tpu_torch.parallel.threed import (make_tp_generate,
                                                  shard_params)
    device = _join(rank, world, tmp)
    cfg, params = tp_f32_model(device)
    out = {}
    for name, (kw, batches) in tp_f32_cases(cfg).items():
        eng = DecodeEngine(params, cfg, device=device,
                           mesh=serving_mesh(world), **dict(ENGINE, **kw))
        if rank:
            eng.follow()
            continue
        start = [r["k5_launches"] for r in eng.stats.ranks]
        tokens = run_batches(eng, batches)
        eng.close()
        out[name] = {"tokens": tokens, "k5": [
            r["k5_launches"] - s for r, s in zip(eng.stats.ranks, start)],
            "stats": {k: getattr(eng.stats, k) for k in (
                "prefix_hits", "prefix_tokens_reused", "preemptions",
                "prefills", "dispatches", "spec_accepted")}}
    mesh = serving_mesh(world)
    fn = make_tp_generate(cfg, mesh, 16, max_len=64)
    got = fn(shard_params(params, cfg, mesh),
             torch.from_numpy(tp_f32_prompt(cfg)).to(device))
    if rank == 0:
        out["generate"] = got.cpu().tolist()
        with open(os.path.join(tmp, "out.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


def tp_nccl_world1(device, cfg, params, kw, batches) -> dict:
    """The tp engine over NCCL at a world of one (NCCL refuses two ranks
    on one card), in this process: its tokens for ``batches``."""
    from kungfu_tpu_torch.comm.mesh import (init_process_group_file,
                                            serving_mesh)
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group_file(os.path.join(tmp, "store"), 0, 1, "nccl")
        try:
            eng = DecodeEngine(params, cfg, device=device,
                               mesh=serving_mesh(1), **dict(ENGINE, **kw))
            tokens = run_batches(eng, batches)
            eng.close()
        finally:
            dist.destroy_process_group()
    return tokens


def phase_tp2_f32(device) -> dict:
    """Full width, 2 layers, f32, tp 2 over gloo on the card
    (:func:`tp_f32_worker`) against tp 1 in this process: each
    :func:`tp_f32_cases` case's greedy tokens, stats and K5 launches (on
    each rank, tp 1's count) equal, :func:`prefix_gate` on the tp-2 run;
    ``make_tp_generate``'s tokens equal ``G.generate``'s; the first case
    over NCCL at a world of one (:func:`tp_nccl_world1`) gives tp 1's
    tokens too."""
    with tempfile.TemporaryDirectory() as tmp:
        _spawn([_worker_argv("tp_f32_worker", r, 2, tmp) for r in range(2)],
               TP_BUDGET_S, tmp)
        with open(os.path.join(tmp, "out.json")) as f:
            got = json.load(f)
    cfg, params = tp_f32_model(device)
    out, first = {}, None
    for name, (kw, batches) in tp_f32_cases(cfg).items():
        eng = DecodeEngine(params, cfg, device=device, **dict(ENGINE, **kw))
        before = PA.launches
        want = run_batches(eng, batches)
        first = first or (kw, batches, want)
        k5 = PA.launches - before
        rec = got[name]
        st = {k: getattr(eng.stats, k) for k in rec["stats"]}
        if rec["tokens"] != want or rec["stats"] != st or any(
                n != k5 for n in rec["k5"]) or not k5:
            raise RuntimeError(f"tp2 {name}: {rec['stats']} K5 {rec['k5']} "
                               f"against tp 1's {st} K5 {k5}; tokens equal:"
                               f" {rec['tokens'] == want}")
        if name.startswith("prefix_"):
            prefix_gate(name[len("prefix_"):], eng.stats)
        out[name] = dict(rec["stats"], k5_launches=rec["k5"])
    want = G.generate(params, cfg, torch.from_numpy(tp_f32_prompt(cfg)).to(
        device), 16, max_len=64).cpu().tolist()
    if got["generate"] != want:
        raise RuntimeError(f"make_tp_generate {got['generate']} != "
                           f"G.generate {want}")
    kw, batches, want = first
    if tp_nccl_world1(device, cfg, params, kw, batches) != want:
        raise RuntimeError("the tp engine over NCCL at a world of one "
                           "differs from tp 1")
    return {"cases": out, "tokens_equal": True, "generate_equal": True,
            "nccl_world1_equal": True}


# ------------------------------------------------ phase 5: K1-K4 (flash)
# The cases, inputs and error measure below are shared with
# tests/test_torch_kernels_cuda.py.
# the 470m training shapes: one microbatch of 2 x 2048, 16 heads, 4 KV
# heads, head_dim 64, causal, bf16
FLASH_470M = dict(B=2, Tq=2048, Tk=2048, H=16, KVH=4, D=64, causal=True,
                  dtype=torch.bfloat16)
FLASH_CASES = {
    # name: B, Tq, Tk, H, KVH, D, causal, dtype, lse cotangent
    "a_bf16_d64_causal_g4": (2, 512, 512, 16, 4, 64, True, "bf16", False),
    "b_f32_d64_causal_g1": (2, 256, 256, 4, 4, 64, True, "f32", False),
    "c_bf16_d128_full_g1": (2, 384, 384, 4, 4, 128, False, "bf16", False),
    "d_f32_d128_causal_g4": (1, 256, 256, 8, 2, 128, True, "f32", False),
    "e_bf16_d64_ragged1000_g4": (1, 1000, 1000, 8, 2, 64, True, "bf16",
                                 False),
    "f_f32_d64_tq192_tk320_g2": (2, 192, 320, 4, 2, 64, True, "f32", False),
    "g_bf16_d128_tq320_tk200_full": (1, 320, 200, 4, 1, 128, False, "bf16",
                                     False),
    "h_bf16_d64_lse_dlse_g4": (2, 256, 256, 8, 2, 64, True, "bf16", True),
    "i_f32_d128_lse_dlse_full": (1, 200, 200, 4, 4, 128, False, "f32",
                                 True),
    "j_bf16_470m_train": (2, 2048, 2048, 16, 4, 64, True, "bf16", False),
    # K4's clusters: g = 8 (the largest portable cluster) and g = 16 (MQA
    # at H = 16, past it: each rank sums two query heads)
    "k_bf16_d128_g8_cluster8": (1, 320, 320, 16, 2, 128, True, "bf16",
                                False),
    "l_bf16_d64_g16_mqa": (2, 200, 200, 16, 1, 64, True, "bf16", False),
    "m_bf16_470m_hd128_train": (2, 2048, 2048, 8, 2, 128, True, "bf16",
                                False),
    # causal with Tq != Tk both ways: K4's column statistics and q range
    "n_bf16_d64_causal_tq192_tk320": (2, 192, 320, 8, 2, 64, True, "bf16",
                                      False),
    "o_bf16_d128_causal_tq320_tk200": (1, 320, 200, 4, 2, 128, True,
                                       "bf16", False),
    # T = 1 with an lse cotangent: without one every gradient is 0 up to
    # rounding (a softmax over one key), which no relative limit can hold
    "p_bf16_d64_t1_lse_dlse": (2, 1, 1, 8, 2, 64, True, "bf16", True),
    "q_bf16_d128_t65_lse_dlse": (1, 65, 65, 8, 2, 128, True, "bf16", True),
    # clusters whose size does not divide K4's 64 rows: g = 12 takes C = 6
    # ranks of two heads (11 rows each, the last 9), g = 3 takes C = 3
    "r_bf16_d64_g12_cluster6": (1, 130, 130, 12, 1, 64, True, "bf16",
                                False),
    "s_bf16_d128_g3_cluster3_full": (2, 96, 96, 6, 2, 128, False, "bf16",
                                     False),
    # K1's wgmma tile loop: MQA at D128 (one K/V ring feeds 16 query
    # heads), and causal T = 130 and 257, where the last q-tile is ragged
    # and ends on another k-tile than the one before it
    "t_bf16_d128_g16_mqa_causal": (1, 256, 256, 16, 1, 128, True, "bf16",
                                   False),
    "u_bf16_d64_causal_t130": (2, 130, 130, 8, 2, 64, True, "bf16", False),
    "v_bf16_d128_causal_t130": (2, 130, 130, 4, 2, 128, True, "bf16",
                                False),
    "w_bf16_d64_causal_t257": (1, 257, 257, 8, 4, 64, True, "bf16", False),
    "x_bf16_d128_causal_t257": (1, 257, 257, 4, 1, 128, True, "bf16",
                                False),
    # the ring-flash chunks of parallel_gpt_470m's job A (sp 2 x tp 2: a
    # rank's 2048 tokens, 8 heads, 2 KV heads), whose lse the merge
    # differentiates: a past chunk and the causal diagonal
    "y_bf16_ring_chunk_full_dlse": (2, 2048, 2048, 8, 2, 64, False, "bf16",
                                    True),
    "z_bf16_ring_diag_causal_dlse": (2, 2048, 2048, 8, 2, 64, True,
                                     "bf16", True),
}
PAR_FLASH_CASES = ("y_bf16_ring_chunk_full_dlse",
                   "z_bf16_ring_diag_causal_dlse")
# Limits on the two errors of flash_errors.  bf16: p and ds are rounded
# before the products and every output once; f32: summation order only.
# lse and delta are f32 sums of the same products in both dtypes, so they
# take the f32 limits.  The "tile" limits sit between the sound kernels'
# readings and those of the planted faults of phase_flash_faults.
FLASH_TOL = {"bf16": {"max": 2e-2, "tile": 1.5e-2},
             "f32": {"max": 1e-4, "tile": 1e-5}}
FLASH_TILE = 64                  # rows along T, the kernels' tile
# kernel -> line of the TPU kernel it replaces in
# kungfu_tpu/ops/flash_attention.py
FLASH_REPLACES = {"fa_fwd": 133, "fa_delta": 279, "fa_bwd_dq": 317,
                  "fa_bwd_dkv": 344}
_DT = {"bf16": torch.bfloat16, "f32": torch.float32}


def flash_errors(key: str, got, want) -> dict:
    """Errors of output ``key`` against its plain version.  "max": the
    largest error over the largest reference value (at least 1).  "tile":
    for each FLASH_TILE rows along T (all batches and heads together),
    ||got - want|| / ||want||, the largest over the tiles.  Under a causal
    mask the late rows' values are far smaller than the first rows', so
    "max" cannot see a late tile that is wrong; "tile" can."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise RuntimeError(f"flash {key}: {got.dtype} {tuple(got.shape)} vs "
                           f"{want.dtype} {tuple(want.shape)}")
    d, w = got.float() - want.float(), want.float()
    axis = 2 if key in ("lse", "delta") else 1          # [B, H, T] rows
    tile = max((dd.norm() / ww.norm().clamp(min=1e-30)).item()
               for dd, ww in zip(d.split(FLASH_TILE, axis),
                                 w.split(FLASH_TILE, axis)))
    return {"max": (d.abs().max() / w.abs().max().clamp(min=1.0)).item(),
            "tile": tile}


def flash_limits(key: str, dt: str) -> dict:
    return FLASH_TOL["f32" if key in ("lse", "delta") else dt]


def flash_over(errs: dict, dt: str) -> dict:
    """The outputs of ``errs`` (key -> flash_errors) above their limits."""
    return {k: e for k, e in errs.items()
            if any(not e[m] <= lim for m, lim in flash_limits(k, dt).items())}


def flash_inputs(device, B, Tq, Tk, H, KVH, D, dtype, seed):
    """q, k, v, the output cotangent (standard normal, in ``dtype``) and
    an lse cotangent (f32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=device).to(dtype)
    return (mk(B, Tq, H, D), mk(B, Tk, KVH, D), mk(B, Tk, KVH, D),
            mk(B, Tq, H, D), torch.randn((B, H, Tq), generator=g,
                                         device=device))


def flash_case(device, name: str) -> dict:
    """Case ``name`` of FLASH_CASES: out, lse, dq, dk, dv through K1-K4
    (the autograd function) against autograd through the plain version,
    same inputs, same dtype.  Returns key -> flash_errors."""
    B, Tq, Tk, H, KVH, D, causal, dt, use_dlse = FLASH_CASES[name]
    g = H // KVH
    q, k, v, do, dlse = flash_inputs(device, B, Tq, Tk, H, KVH, D, _DT[dt],
                                     100 + list(FLASH_CASES).index(name))
    res = {}
    for path in ("kernel", "plain"):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        if path == "kernel":
            out, lse = FA.flash_attention_with_lse(qq, kk, vv, causal,
                                                   kv_groups=g)
        else:
            out, lse = FA.flash_attention_ref(
                qq, FA._expand_kv_heads(kk, g), FA._expand_kv_heads(vv, g),
                causal)
        loss = (out.float() * do.float()).sum()
        if use_dlse:
            loss = loss + (lse * dlse).sum()
        loss.backward()
        res[path] = (out.detach(), lse.detach(), qq.grad, kk.grad, vv.grad)
    return {key: flash_errors(key, got, want) for key, got, want in
            zip(("out", "lse", "dq", "dk", "dv"), res["kernel"],
                res["plain"])}


def phase_flash_check(device, names=None) -> dict:
    """Every case of FLASH_CASES (or those ``names``) within its limits."""
    errs = {}
    for name in names or FLASH_CASES:
        case = FLASH_CASES[name]
        errs[name] = flash_case(device, name)
        emit({"phase": "flash_check", "case": name, "err": errs[name],
              "tol": FLASH_TOL[case[7]]})
        bad = flash_over(errs[name], case[7])
        if bad:
            raise RuntimeError(f"flash {name}: {bad} above the limits "
                               f"{FLASH_TOL[case[7]]} (lse, delta: f32)")
    return errs


def _plain_chain(q, k, v, do, g, keep):
    """out, lse, dq, dk, dv by autograd through plain attention (f32
    scores) under the boolean mask ``keep`` [Tq, Tk]."""
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qq.float(),
                     FA._expand_kv_heads(kk, g).float()) / math.sqrt(
                         q.shape[-1])
    s = torch.where(keep, s, FA.NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                       FA._expand_kv_heads(vv, g).float()).to(q.dtype)
    (out.float() * do.float()).sum().backward()
    return out.detach(), lse.detach(), qq.grad, kk.grad, vv.grad


def _tiled_forward(q, k, v, g, keep, fault=None):
    """The online-softmax forward over FLASH_TILE-key tiles, sound or with
    a planted fault: "no_rescale", the output accumulator never takes the
    correction when the running max rises; "pv_after_rescale", K1's
    pipelined order broken: the previous tile's p V, still in flight when
    this tile's max rises, lands after acc's rescale and misses it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     FA._expand_kv_heads(k, g).float()) / math.sqrt(
                         q.shape[-1])
    s = torch.where(keep, s, FA.NEG_INF)
    ve = FA._expand_kv_heads(v, g).float()
    m = torch.full(s.shape[:3], -math.inf, device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device).permute(0, 2, 1, 3)
    pending = torch.zeros_like(acc)
    for j in range(0, s.shape[3], FLASH_TILE):
        sj = s[..., j:j + FLASH_TILE]
        m_new = torch.maximum(m, sj.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sj - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p, ve[:, j:j + FLASH_TILE])
        if fault == "no_rescale":
            acc = acc + pv
        elif fault == "pv_after_rescale":
            acc, pending = acc * alpha[..., None] + pending, pv
        else:
            acc = acc * alpha[..., None] + pv
        m = m_new
    acc = acc + pending
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


def phase_flash_faults(device) -> dict:
    """How far flash_errors' "tile" reading moves for a kernel with a
    planted fault, at the 470m training shapes: each fault computed with
    plain PyTorch against the sound plain chain on the same inputs.  Every
    output's smallest fault reading must lie above its limit, or the
    check of phase_flash_check could not see that fault."""
    s = FLASH_470M
    B, T, H, KVH, D = s["B"], s["Tq"], s["H"], s["KVH"], s["D"]
    g, dt = H // KVH, "bf16"
    q, k, v, do, _ = flash_inputs(device, B, T, T, H, KVH, D, s["dtype"], 9)
    qpos = torch.arange(T, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    causal = qpos >= kpos
    keys = ("out", "lse", "dq", "dk", "dv")
    sound = dict(zip(keys, _plain_chain(q, k, v, do, g, causal)))
    last = T - FLASH_TILE
    faulty = {
        # rows past the first tile skip k-tile 0
        "skip_first_ktile": _plain_chain(
            q, k, v, do, g,
            causal & ~((kpos < FLASH_TILE) & (qpos >= FLASH_TILE))),
        # the last q-tile skips its diagonal (straddling) k-tile
        "skip_last_diag_ktile": _plain_chain(
            q, k, v, do, g, causal & ~((kpos >= last) & (qpos >= last))),
        # K4 sums g - 1 of its g query heads (the last one's dO is 0)
        "dkv_drop_query_head": _plain_chain(
            q, k, v, do.unflatten(2, (KVH, g)).index_fill(
                3, torch.tensor([g - 1], device=device), 0).flatten(2, 3),
            g, causal),
    }
    readings = {name: {key: flash_errors(key, got, sound[key])["tile"]
                       for key, got in zip(keys, outs)
                       if not (name == "dkv_drop_query_head"
                               and key not in ("dk", "dv"))}
                for name, outs in faulty.items()}
    with torch.no_grad():
        for fault in ("no_rescale", "pv_after_rescale"):
            readings[fault] = {"out": flash_errors(
                "out", _tiled_forward(q, k, v, g, causal, fault),
                sound["out"])["tile"]}
        tiled_sound = flash_errors(
            "out", _tiled_forward(q, k, v, g, causal), sound["out"])["tile"]
        delta = FA._delta_plain(sound["out"], do)
        cut = delta.clone()
        cut[..., last:] = 0
        readings["delta_last_tile_unwritten"] = {
            "delta": flash_errors("delta", cut, delta)["tile"]}
    least = {}
    for faults in readings.values():
        for key, r in faults.items():
            least[key] = min(least.get(key, math.inf), r)
    blind = {key: r for key, r in least.items()
             if not r > flash_limits(key, dt)["tile"]}
    if blind or not tiled_sound <= flash_limits("out", dt)["tile"]:
        raise RuntimeError(f"flash limits {FLASH_TOL} cannot see the faults "
                           f"{blind} (the rescaled tiled forward reads "
                           f"{tiled_sound})")
    return {"readings": readings, "least": least,
            "tiled_forward_sound": tiled_sound}


def flash_bound(kernel: str, B, Tq, Tk, H, KVH, D, causal, dtype) -> dict:
    """Least time of one call at these shapes: each input read once and
    each output written once over 3.35 TB/s, against the products the
    visible (query, key) pairs need at the dtype's peak; the larger
    bounds it."""
    isz = torch.tensor([], dtype=dtype).element_size()
    if causal:
        pairs = sum(min(t + 1, Tk) for t in range(Tq))
    else:
        pairs = Tq * Tk
    qb, kvb, row = B * Tq * H * D * isz, B * Tk * KVH * D * isz, B * H * Tq * 4
    nbytes, flops = {
        "fa_fwd": (qb + 2 * kvb + qb + row, 4 * B * H * D * pairs),
        "fa_delta": (2 * qb + row, 2 * B * Tq * H * D),
        "fa_bwd_dq": (2 * qb + 2 * kvb + 2 * row + qb,
                      6 * B * H * D * pairs),
        "fa_bwd_dkv": (2 * qb + 2 * kvb + 2 * row + 2 * kvb,
                       8 * B * H * D * pairs),
    }[kernel]
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


# the shapes phase_flash_time times, every kernel at each: the 470m
# training shapes and the 470m-hd128 ones (8 heads of 128, 2 KV heads)
FLASH_TIME_SHAPES = {
    "470m": FLASH_470M,
    "470m_hd128": dict(FLASH_470M, H=8, KVH=2, D=128),
}
BWD = ("fa_delta", "fa_bwd_dq", "fa_bwd_dkv")


def flash_time_shape(device, timer, shape: dict, kernels) -> dict:
    """``kernels`` at ``shape``: each against its plain version on the
    same inputs (flash_errors within the limits, and the max abs error),
    timed beside its bound and the plain version.  Library yardsticks the
    port never calls: SDPA's forward (K1) and backward (K3 + K4; it also
    computes delta), torch.linalg.vecdot (K2).  When K2-K4 are all timed,
    adds "bwd": K2 + K3 + K4 summed beside the SDPA backward."""
    B, Tq, Tk, H, KVH, D = (shape[k] for k in ("B", "Tq", "Tk", "H", "KVH",
                                               "D"))
    causal, dtype, g = shape["causal"], shape["dtype"], H // KVH
    q, k, v, do, _ = flash_inputs(device, B, Tq, Tk, H, KVH, D, dtype, 7)
    plain_fwd = lambda: FA.flash_attention_ref(
        q, FA._expand_kv_heads(k, g), FA._expand_kv_heads(v, g), causal)
    out, lse = FA.flash_forward(q, k, v, causal, g)
    delta = FA.flash_delta(out, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, causal, g)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, causal, g)
    calls = {
        "fa_fwd": (lambda: FA.flash_forward(q, k, v, causal, g),
                   plain_fwd),
        "fa_delta": (lambda: FA.flash_delta(out, do),
                     lambda: FA._delta_plain(out, do)),
        "fa_bwd_dq": (lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta,
                                              causal, g),
                      lambda: FA._dq_plain(q, k, v, do, lse, delta, causal,
                                           g)),
        "fa_bwd_dkv": (lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                causal, g),
                       lambda: FA._dkv_plain(q, k, v, do, lse, delta,
                                             causal, g)),
    }
    got = {"fa_fwd": {"out": out, "lse": lse},
           "fa_delta": {"delta": delta}, "fa_bwd_dq": {"dq": dq},
           "fa_bwd_dkv": {"dk": dk, "dv": dv}}
    checks, max_abs = {}, {}
    with torch.no_grad():
        for name in kernels:
            want = calls[name][1]()
            want = want if isinstance(want, tuple) else (want,)
            checks[name] = {key: flash_errors(key, t, w) for (key, t), w
                            in zip(got[name].items(), want)}
            max_abs[name] = max((t.float() - w.float()).abs().max().item()
                                for t, w in zip(got[name].values(), want))
            bad = flash_over(checks[name], "bf16")
            if bad:
                raise RuntimeError(f"{name} at {shape}: {bad} above the "
                                   f"limits {FLASH_TOL}")
    # the yardsticks: one SDPA call forward, and its backward (dq, dk, dv
    # together, so it stands beside K3 + K4); rowsum(dO * O) in one call
    # (bf16 [B, T, H] where K2 writes f32 [B, H, T])
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    s_out = sdpa()
    s_bwd = lambda: torch.autograd.grad(s_out, (qt, kt, vt),
                                        do.transpose(1, 2),
                                        retain_graph=True)
    library = {"fa_fwd": ("sdpa forward", lambda: timer(sdpa)),
               "fa_delta": ("torch.linalg.vecdot(out, dout, dim=-1)",
                            lambda: timer(lambda: torch.linalg.vecdot(
                                out, do, dim=-1)))}
    recs = {}
    with torch.no_grad():
        for name in kernels:
            kern, plain = calls[name]
            recs[name] = {"ms": timer(kern), "plain_ms": timer(plain),
                          "max_abs_err": max_abs[name],
                          "err": checks[name],
                          **flash_bound(name, **shape)}
            if name in library:
                recs[name]["library"] = library[name][0]
                recs[name]["library_ms"] = library[name][1]()
    bwd_ms = timer(s_bwd)
    for name in ("fa_bwd_dq", "fa_bwd_dkv"):
        if name in recs:
            recs[name]["library"] = "sdpa backward (dq, dk, dv in one call)"
            recs[name]["library_ms"] = bwd_ms
    if all(name in recs for name in BWD):
        bound = [flash_bound(name, **shape) for name in BWD]
        recs["bwd"] = {
            "ms": sum(recs[name]["ms"] for name in BWD),
            "bound_ms": sum(b["bound_ms"] for b in bound),
            "flops": sum(b["flops"] for b in bound),
            "library": "sdpa backward (delta, dq, dk, dv in one call)",
            "library_ms": bwd_ms}
    return recs


def phase_flash_time(device) -> dict:
    """K1-K4 at the 470m and at the 470m-hd128 training shapes
    (flash_time_shape), one line per kernel and shape.  Returns
    {shape: {kernel: record}}."""
    timer = Timer(device)
    out = {}
    for tag, shape in FLASH_TIME_SHAPES.items():
        out[tag] = flash_time_shape(device, timer, shape, FLASH_REPLACES)
        for name, rec in out[tag].items():
            emit({"phase": "flash_time", "shape": tag, "kernel": name,
                  **rec, "tflops": rec["flops"] / rec["ms"] / 1e9})
    return out


# ----------------------------------------------- phase 6: train the 470m
def _reset_flash_counts() -> None:
    for name in FA.launches:
        FA.launches[name] = 0


def phase_train(device, preset: str = "470m") -> dict:
    """The main training path: ``python -m kungfu_tpu_torch.benchmarks.gpt
    --preset <preset>`` on the card (470m and 470m-hd128: 64 x 2048 tokens
    a step in 32 microbatches, synchronous-SGD AdamW, bf16 compute over
    f32 masters), 1 warm-up step and 2 timed steps, through the
    benchmark's own code.  Every layer of every microbatch must have
    launched K1-K4."""
    args = BG.parse_args(["--preset", preset, "--warmup-steps", "1",
                          "--steps", "2", "--device", "cuda"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with BG.solo_group(device):
        _reset_flash_counts()             # counts from the main path only
        out = BG.train(args, device)
        counts = dict(FA.launches)
    steps = args.warmup_steps + args.steps
    need = args.n_layers * args.accum * steps
    short = {k: n for k, n in counts.items() if n < need}
    if short:
        raise RuntimeError(f"flash kernels launched {short} times, the "
                           f"{preset} run needed {need} each "
                           f"({args.n_layers} layers x {args.accum} "
                           f"microbatches x {steps} steps)")
    if not all(math.isfinite(x) for x in out["step_losses"]):
        raise RuntimeError(f"non-finite loss: {out['step_losses']}")
    return {"preset": preset, "tokens_per_s": out["value"],
            "model_tflops_per_s": out["model_tflops_per_sec"],
            "mfu": out["model_tflops_per_sec"] * 1e12 / BF16_FLOPS,
            "step_losses": out["step_losses"],
            "step_seconds": out["step_seconds"],
            "params": out["params"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts, "launches_needed": need,
            "json_line": {k: out[k] for k in (
                "metric", "value", "unit", "params",
                "model_tflops_per_sec", "loss", "backend", "device")}}


def profile_run(run) -> tuple:
    """``run()`` once under torch.profiler, ending synchronised: the
    device time and launches by kernel name, and the wall time, device
    busy time and share (summed kernel time / wall time; one stream), the
    launches and the top 10 kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            kernels[ev.key] = (kernels.get(ev.key, (0, 0))[0]
                               + ev.self_device_time_total,
                               kernels.get(ev.key, (0, 0))[1] + ev.count)
    busy_us = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return kernels, {
        "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "launches": sum(v[1] for v in kernels.values()),
        "top_kernels_ms": [[k[:90], v[0] / 1e3, v[1]] for k, v in top]}


def phase_train_profile(device, preset: str = "470m") -> dict:
    """Where a microbatch's time goes (470m or 470m-hd128): one forward +
    backward of the training loss (2 x 2048 tokens, bf16 compute copy)
    under torch.profiler."""
    from kungfu_tpu_torch.training import _cast_params
    from kungfu_tpu_torch.utils.tree import tree_leaves
    args = BG.parse_args(["--preset", preset, "--device", "cuda"])
    cfg = BG.make_config(args)
    params = _cast_params(G.init_params(
        torch.Generator(device=device).manual_seed(0), cfg), cfg.dtype)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss_fn = BG.make_loss_fn(args, cfg)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, args.seq))
                            ).to(device=device, dtype=torch.int32)
    batch = (toks, torch.roll(toks, -1, dims=1))

    def micro():
        return torch.autograd.grad(loss_fn(params, batch), leaves)

    micro()                                            # warm-up
    kernels, rec = profile_run(micro)
    flash = {name: sum(v[0] for k, v in kernels.items()
                       if f"{name}<" in k) / 1e3
             for name in FA.launches}
    top = rec.pop("top_kernels_ms")
    return {**rec, "flash_ms": flash, "top_kernels_ms": top}


def phase_train_flash_vs_dense_f32_2l(device) -> dict:
    """A full-width 2-layer f32 470m trained for 2 steps (8 x 2048 tokens,
    microbatches of 2 x 2048) through the kernels and through the dense
    oracle, from the same seed.  Losses agree to 1e-4 relative (f32
    summation order).  Parameters: AdamW's first steps move each weight
    by about +-lr whatever the gradient's size, so a gradient within
    rounding of 0 may flip its step: at most 2 x lr x steps apart, and
    all but 1e-4 of the weights within 1e-5."""
    out = {}
    for attn in ("flash", "dense"):
        args = BG.parse_args(["--preset", "470m", "--n-layers", "2",
                              "--f32", "--batch", "8", "--accum", "4",
                              "--warmup-steps", "0", "--steps", "2",
                              "--attn", attn, "--device", "cuda"])
        with BG.solo_group(device):
            before = dict(FA.launches)
            out[attn] = BG.train(args, device)
            out[attn]["fa_fwd"] = FA.launches["fa_fwd"] - before["fa_fwd"]
    if out["flash"]["fa_fwd"] == 0 or out["dense"]["fa_fwd"] != 0:
        raise RuntimeError("flash/dense runs took the wrong attention")
    from kungfu_tpu_torch.utils.tree import tree_leaves
    lf, ld = out["flash"]["step_losses"], out["dense"]["step_losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, ld))
    diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(
        tree_leaves(out["flash"]["params_tree"]),
        tree_leaves(out["dense"]["params_tree"]))])
    max_diff = diffs.max().item()
    off = (diffs > 1e-5).float().mean().item()
    bound = 2 * 3e-4 * 2
    if not (loss_rel <= 1e-4 and max_diff <= bound and off <= 1e-4):
        raise RuntimeError(f"flash vs dense: loss rel {loss_rel}, param "
                           f"max diff {max_diff} (bound {bound}), share "
                           f"above 1e-5 {off}")
    return {"losses_flash": lf, "losses_dense": ld, "loss_rel_diff":
            loss_rel, "param_max_abs_diff": max_diff,
            "param_share_above_1e-5": off}


# ------------------------------------------------- phase 7: K6 (no softmax)
# The cases, inputs and measure below are shared with
# tests/test_torch_kernels_cuda.py: the roofline's four K6 shapes and
# ragged T at both head dims, causal and not.
NOSOFTMAX_CASES = {
    # name: B, T, H, D, causal
    "a_d64_full": (4, 2048, 12, 64, False),
    "b_d128_full": (4, 2048, 8, 128, False),
    "c_d64_causal": (4, 2048, 12, 64, True),
    "d_d64_causal_ragged1000": (1, 1000, 2, 64, True),
    "e_d128_causal": (4, 2048, 8, 128, True),
    "f_d128_causal_t65": (2, 65, 3, 128, True),
    "g_d64_causal_t130": (2, 130, 3, 64, True),
    "h_d128_full_t200": (1, 200, 2, 128, False),
}
# K6's output is held to FLASH_TOL["bf16"] ("out"): the kernel rounds s to
# bf16 where its plain version does, and its output once, but sums the
# f32 products in another order, so an s near a rounding boundary may
# land one bf16 step apart.


# the roofline's K6 cases and their rows in the roofline artifact
K6_ROWS = {"a_d64_full": "kernel_ceiling_matmul_only_B4_T2048_H12_D64",
           "b_d128_full": "kernel_ceiling_matmul_only_B4_T2048_H8_D128",
           "c_d64_causal":
               "kernel_ceiling_matmul_only_causal_B4_T2048_H12_D64",
           "e_d128_causal":
               "kernel_ceiling_matmul_only_causal_B4_T2048_H8_D128"}


def nosoftmax_inputs(device, B, T, H, D, seed):
    """q, k, v [B, H, T, D], standard normal in bf16."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((B, H, T, D), generator=g, device=device)
                 .to(torch.bfloat16) for _ in range(3))


def nosoftmax_errors(got, want) -> dict:
    """flash_errors of K6's [B, H, T, D] output: tiles of 64 rows along T."""
    return flash_errors("out", got.transpose(1, 2), want.transpose(1, 2))


def nosoftmax_case(device, name: str):
    """Case ``name`` of NOSOFTMAX_CASES through K6 and through its plain
    version at the kernel's 64 x 64 blocks: (errors, max abs error,
    (q, k, v), plain output)."""
    B, T, H, D, causal = NOSOFTMAX_CASES[name]
    q, k, v = nosoftmax_inputs(device, B, T, H, D,
                               200 + list(NOSOFTMAX_CASES).index(name))
    with torch.no_grad():
        got = RL.nosoftmax_attention(q, k, v, causal)
        want = RL._nosoftmax_plain(q, k, v, causal)
    return (nosoftmax_errors(got, want),
            (got.float() - want.float()).abs().max().item(), (q, k, v), want)


def nosoftmax_fault(q, k, v, causal: bool):
    """K6 with a planted fault, computed by the plain code: every q-tile
    skips its last visible k-tile (the diagonal one under causal, the
    last one otherwise)."""
    T = q.shape[2]
    keep = RL._block_keep(T, causal, RL.TILE, RL.TILE, q.device)
    tiles = torch.arange(T, device=q.device) // RL.TILE
    last = tiles if causal else tiles[-1].expand_as(tiles)
    return RL._nosoftmax_masked(q, k, v,
                                keep & (tiles[None, :] != last[:, None]))


def phase_nosoftmax_check(device) -> dict:
    """Every case of NOSOFTMAX_CASES within the bf16 limits, and the
    planted fault's tile reading above the tile limit in every case."""
    limit = FLASH_TOL["bf16"]["tile"]
    res = {}
    for name, case in NOSOFTMAX_CASES.items():
        errs, max_abs, (q, k, v), want = nosoftmax_case(device, name)
        with torch.no_grad():
            fault = nosoftmax_errors(nosoftmax_fault(q, k, v, case[4]),
                                     want)["tile"]
        res[name] = {"err": errs, "max_abs_err": max_abs,
                     "fault_tile": fault}
        emit({"phase": "nosoftmax_check", "case": name, **res[name],
              "tol": FLASH_TOL["bf16"]})
        if flash_over({"out": errs}, "bf16"):
            raise RuntimeError(f"K6 {name}: {errs} above the limits "
                               f"{FLASH_TOL['bf16']}")
        if not fault > limit:
            raise RuntimeError(f"K6 {name}: the planted fault reads {fault}, "
                               f"not above the tile limit {limit}")
    return res


def k6_bound(B, T, H, D, causal) -> dict:
    """Least time of one K6 call: the products of the visible 64 x 64
    block pairs (whole, as the kernel computes them) at the bf16 peak,
    against q, k, v read and out written once over 3.35 TB/s."""
    pairs = RL._visible_block_pairs(T, causal, RL.TILE, RL.TILE)
    flops = 4 * B * H * D * RL.TILE * RL.TILE * pairs
    nbytes = 4 * B * H * T * D * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def phase_k6_time(device, checks: dict) -> dict:
    """K6 at the roofline's four shapes, timed beside its bound, its
    plain version and a library form where one exists: for the
    non-causal shapes two torch.matmul calls (s comes out in bf16, as K6
    rounds it); no library call computes the causal block skip."""
    timer = Timer(device)
    recs = {}
    for name in K6_ROWS:
        B, T, H, D, causal = NOSOFTMAX_CASES[name]
        q, k, v = nosoftmax_inputs(device, B, T, H, D, 7)
        with torch.no_grad():
            rec = {"ms": timer(lambda: RL.nosoftmax_attention(q, k, v,
                                                              causal)),
                   "plain_ms": timer(lambda: RL._nosoftmax_plain(q, k, v,
                                                                 causal)),
                   "max_abs_err": checks[name]["max_abs_err"],
                   **k6_bound(B, T, H, D, causal)}
            if causal:
                rec["library_ms"] = None
                rec["library"] = ("none: no library call computes the "
                                  "causal block skip")
            else:
                rec["library_ms"] = timer(lambda: torch.matmul(
                    torch.matmul(q, k.transpose(-1, -2)), v))
                rec["library"] = "two torch.matmul calls; no single call"
        emit({"phase": "k6_time", "case": name, **rec,
              "tflops_done": rec["flops"] / rec["ms"] / 1e9})
        recs[name] = rec
    return recs


# ------------------------------------------------------ phase 8: roofline
ROOFLINE_OPS = (
    "matmul_4096x4096x4096_bf16",
    "flash_fwd_B4_T2048_H12_D64", "flash_fwdbwd_B4_T2048_H12_D64",
    "flash_fwd_B4_T2048_H8_D128", "flash_fwdbwd_B4_T2048_H8_D128",
    *K6_ROWS.values(),
    "library_flash_fwd_B4_T2048_H12_D64", "library_flash_fwd_B4_T2048_H8_D128",
    "hbm_copy_512MiB")


def phase_roofline(device, smi: str, k6_times: dict) -> dict:
    """The roofline's main path, ``kungfu_tpu_torch.benchmarks.roofline``'s
    main() into a temporary file, with K6's launches counted over that run
    only.  From its rows: K1 over K6, the time per useful flop of the
    flash forward over that of its tile loop without the softmax (causal
    against causal at D64 and D128 the same work, so 1 - K6 / K1 is the
    softmax's share of K1's time; at D128 also the causal K1 against the
    non-causal K6, which adds the causal structure's cost); the flash
    forward over the measured matmul ceiling; and the measured ceilings
    beside the data-sheet constants the bounds use.  A roofline row
    flushes L2 once per run of 8 calls, so its later calls may find their
    inputs in L2; ``k6_l2`` sets each K6 row beside ``k6_times``
    (k6_time: one call per run, L2 flushed before every call) to show
    what that costs."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "roofline.json")
        RL.launches["nosoftmax"] = 0       # counts from the main path only
        RL.main(["--out", path])
        launches = RL.launches["nosoftmax"]
        with open(path) as f:
            doc = json.load(f)
    rows = {r["op"]: r for r in doc["results"]}
    missing = [op for op in ROOFLINE_OPS if op not in rows]
    if missing or launches == 0 or doc["device"] != smi:
        raise RuntimeError(f"roofline: rows {missing} missing, K6 launched "
                           f"{launches} times, device {doc['device']!r}")
    for r in doc["results"]:
        emit({"phase": "roofline_row", **r})
    k1_k6 = {}
    for tag, k1, k6 in (
            ("d64_causal", "flash_fwd_B4_T2048_H12_D64",
             K6_ROWS["c_d64_causal"]),
            ("d128_causal", "flash_fwd_B4_T2048_H8_D128",
             K6_ROWS["e_d128_causal"]),
            ("d128", "flash_fwd_B4_T2048_H8_D128", K6_ROWS["b_d128_full"])):
        ratio = rows[k6]["tflops"] / rows[k1]["tflops"]
        k1_k6[tag] = {"k1": k1, "k6": k6, "k1_over_k6": ratio,
                      "softmax_share": 1 - 1 / ratio}
    k6_l2 = {name: {"op": op, "flushed_each_call_ms": k6_times[name]["ms"],
                    "flushed_each_run_ms": rows[op]["ms"],
                    "each_call_over_each_run":
                        k6_times[name]["ms"] / rows[op]["ms"]}
             for name, op in K6_ROWS.items()}
    mm = rows["matmul_4096x4096x4096_bf16"]["tflops"]
    hbm = rows["hbm_copy_512MiB"]["gib_per_s"] * 2 ** 30
    return {"artifact_device": doc["device"], "k6_launches": launches,
            "k1_over_k6": k1_k6, "k6_l2": k6_l2,
            "flash_fwd_over_matmul": {
                "d64": rows["flash_fwd_B4_T2048_H12_D64"]["tflops"] / mm,
                "d128": rows["flash_fwd_B4_T2048_H8_D128"]["tflops"] / mm},
            "matmul_tflops": mm, "matmul_over_datasheet": mm * 1e12
            / BF16_FLOPS, "hbm_tb_per_s": hbm / 1e12,
            "hbm_over_datasheet": hbm / HBM_BYTES_PER_S,
            "datasheet": {"bf16_tflops": BF16_FLOPS / 1e12,
                          "hbm_tb_per_s": HBM_BYTES_PER_S / 1e12}}


# ------------------------------------------- phase 10: ResNet-50 training
# Limits, each as a share of the reference's largest |value| (logits) or
# of max(1, |value|) per tensor (statistics, parameters):
# - f32 on the card against f32 on the CPU, the same weights and batch:
#   convolution algorithms and reduction orders differ (cuDNN may take
#   Winograd or FFT forms in f32; TF32 is off), nothing else;
# - bf16 on the card against f32 on the card: bf16 activations through
#   50 layers (8 bits of mantissa, about 4e-3 a rounding).
RESNET_TOL = {"f32": 1e-3, "bf16": 5e-2}
RESNET_CHECK_BATCH, RESNET_CHECK_IMAGE = 8, 224


def resnet_perturb(model, seed: int = 0):
    """Move every BatchNorm's scale, bias and running statistics off
    their initial values, in place, from a seed: a block's last scale
    starts at 0 and would hide its branch (it gets 0.2 N(0, 1)), and
    statistics at 0 and 1 would hide what eval mode does with them."""
    from kungfu_tpu_torch.models.resnet import BatchNorm
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                base = 0.0 if name.endswith("BatchNorm_2") else 1.0
                m.weight.copy_(base + 0.2 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return model


def _excess(got: dict, want: dict, tol: float, per_tensor: bool) -> float:
    """Largest |got - want| over tol x (max |want| of the whole, or of
    each tensor but at least 1)."""
    if per_tensor:
        return max(float((got[k].float() - w.float()).abs().max()
                         / (tol * max(1.0, float(w.abs().max()))))
                   for k, w in want.items())
    (g,), (w,) = got.values(), want.values()
    return float((g - w).abs().max() / (tol * w.abs().max()))


def resnet_outputs(model, x, y) -> dict:
    """Eval logits, train logits and the running statistics after that
    train forward, then (from the starting statistics) the loss, the
    parameters and the statistics after one step of the bench's train
    step, all on the CPU."""
    dev = next(model.parameters()).device
    x, y = x.to(dev), y.to(dev)
    buffers = dict(model.named_buffers())
    start = {k: v.clone() for k, v in buffers.items()}
    host = lambda named: {k: v.detach().float().cpu() for k, v in named}
    out = {}
    with torch.no_grad():
        out["eval"] = {"logits": model.eval()(x).float().cpu()}
        out["train"] = {"logits": model.train()(x).float().cpu()}
        out["stats"] = host(buffers.items())
        for k, v in buffers.items():
            v.copy_(start[k])
    with BG.solo_group(dev):
        step = BR.build_step(model, flat_mesh(n=1))
        out["loss"] = {"loss": step((x, y)).float().cpu().reshape(1)}
    out["params_step"] = host(model.named_parameters())
    out["stats_step"] = host(model.named_buffers())
    return out


def resnet_compare(got: dict, want: dict, tol: float) -> dict:
    """Each output of :func:`resnet_outputs` as a multiple of its limit."""
    return {k: _excess(got[k], want[k], tol,
                       k in ("stats", "params_step", "stats_step"))
            for k in want}


def resnet_card_vs_cpu(device, batch: int, image: int,
                       stage_sizes=(3, 4, 6, 3)) -> dict:
    """The same f32 ResNet (seeded, BatchNorm perturbed) and batch on the
    card and on the CPU: each output of :func:`resnet_outputs` as a
    multiple of ``RESNET_TOL["f32"]`` (> 1 fails)."""
    from kungfu_tpu_torch.models.resnet import ResNet
    args = BR.parse_args(["--batch", str(batch), "--image-size",
                          str(image), "--f32"])
    ref = resnet_perturb(ResNet(list(stage_sizes), dtype=torch.float32
                                ).init(0))
    card = copy.deepcopy(ref).to(device)
    x, y = BR.make_batch(args, torch.device("cpu"))
    return resnet_compare(resnet_outputs(card, x, y),
                          resnet_outputs(ref, x, y), RESNET_TOL["f32"])


def phase_resnet_check(device) -> dict:
    """Full ResNet-50 (224 x 224, 1000 classes) in f32 on the card against
    the same converted weights on the CPU, at a batch of 8; then the bf16
    model against the f32 one on the card.  Any output over its limit
    fails the phase."""
    from kungfu_tpu_torch.models.resnet import ResNet50
    t0 = time.perf_counter()
    f32 = resnet_card_vs_cpu(device, RESNET_CHECK_BATCH, RESNET_CHECK_IMAGE)
    args = BR.parse_args(["--batch", str(RESNET_CHECK_BATCH)])
    ref = resnet_perturb(ResNet50(dtype=torch.float32).init(0))
    bf = ResNet50(dtype=torch.bfloat16)
    bf.load_state_dict(ref.state_dict())
    x, y = BR.make_batch(args, torch.device("cpu"))
    bf16 = resnet_compare(resnet_outputs(bf.to(device), x, y),
                          resnet_outputs(ref.to(device), x, y),
                          RESNET_TOL["bf16"])
    over = {f"{tag}.{k}": v for tag, d in (("f32", f32), ("bf16", bf16))
            for k, v in d.items() if not v <= 1}
    if over:
        raise RuntimeError(f"ResNet-50 outputs over their limits "
                           f"{RESNET_TOL}: {over}")
    return {"batch": RESNET_CHECK_BATCH, "image": RESNET_CHECK_IMAGE,
            "limits": RESNET_TOL, "f32_card_vs_cpu_over_limit": f32,
            "bf16_vs_f32_card_over_limit": bf16,
            "seconds": time.perf_counter() - t0}


def phase_train_resnet50(device) -> dict:
    """The main path: ``python -m kungfu_tpu_torch.benchmarks.resnet`` on
    the card through the bench entry's own code (full-width ResNet-50,
    224 x 224, batch 256, bf16 over f32 parameters, sync-SGD nesterov,
    5 warm-up and 20 timed steps)."""
    args = BR.parse_args(["--device", "cuda"])
    torch.cuda.empty_cache()
    with BG.solo_group(device):
        out = BR.train(args, device)
    if out["metric"] != "resnet50_images_per_sec_per_gpu" or not all(
            math.isfinite(out[k]) for k in ("loss_first", "loss_last")):
        raise RuntimeError(f"ResNet-50 run: {out}")
    return out


# kernel groups of a ResNet step, by name (first match wins)
RESNET_GROUPS = (("conv", r"cudnn|cutlass|xmma|fprop|dgrad|wgrad|conv"
                  r"|implicit_gemm|sm90_"),
                 ("batch_norm", r"batch_norm"), ("nccl", r"nccl"),
                 ("optimizer", r"multi_tensor"), ("pooling", r"pool"))


def phase_train_resnet50_profile(device, steps: int = 10) -> dict:
    """Where a ResNet-50 step's time goes: one whole step of the bench's
    train step (forward, backward, SGD, the state average, batch 256)
    under torch.profiler, after 3 warm-up steps, with its device time by
    kernel group; then ``steps`` steps back to back without the profiler:
    the host time for ``step()`` to return (the launches it issues) and
    the time a step takes in steady state (host clock, one sync at the
    end).  Host time near the steady step time means the host sets the
    pace."""
    args = BR.parse_args(["--device", "cuda"])
    torch.backends.cudnn.benchmark = True   # as the bench entry runs
    with BG.solo_group(device):
        model = BR.make_model(args, device).train()
        step = BR.build_step(model, flat_mesh(n=1))
        batch = BR.make_batch(args, device)
        for _ in range(3):
            float(step(batch))
        kernels, rec = profile_run(lambda: float(step(batch)))
        host = []
        t0 = time.perf_counter()
        for _ in range(steps):
            t1 = time.perf_counter()
            loss = step(batch)
            host.append(time.perf_counter() - t1)
        float(loss)
        steady = (time.perf_counter() - t0) / steps
    groups = {}
    for name, (us, _) in kernels.items():
        g = next((g for g, pat in RESNET_GROUPS if re.search(pat, name)),
                 "elementwise_and_other")
        groups[g] = groups.get(g, 0.0) + us / 1e3
    return {"batch": args.batch, **rec, "device_ms_by_group": groups,
            "steady_ms_per_step": steady * 1e3,
            "host_ms_per_step": statistics.median(host) * 1e3,
            "steady_busy_share": rec["device_busy_ms"] / (steady * 1e3)}


PREFETCH_BATCHES = 4


def phase_prefetch(device) -> dict:
    """The Prefetcher at the bench's batch ([256, 224, 224, 3] f32, 154
    MB): 4 distinct batches staged through pinned memory on a side
    stream must arrive bit-identical and in order; the H2D rate of one
    pinned batch (CUDA events) and the pipeline's rate (host clock over
    the 4).  Then one ResNet-50 step fed from the Prefetcher must give
    the loss of the same batch fed directly."""
    from kungfu_tpu_torch.data.pipeline import Prefetcher, to_device
    args = BR.parse_args(["--device", "cuda"])
    rng = np.random.RandomState(3)
    src = [rng.rand(args.batch, args.image_size, args.image_size, 3
                    ).astype(np.float32) for _ in range(PREFETCH_BATCHES)]
    nbytes = src[0].nbytes
    pinned = torch.from_numpy(src[0]).pin_memory()
    pinned.to(device, non_blocking=True)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    pinned.to(device, non_blocking=True)
    ev[1].record()
    torch.cuda.synchronize()
    h2d_ms = ev[0].elapsed_time(ev[1])
    t0 = time.perf_counter()
    with Prefetcher(iter(src), depth=2, place=to_device(device)) as pf:
        staged = list(pf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = [torch.equal(t.cpu(), torch.from_numpy(a))
            for t, a in zip(staged, src)]
    if len(staged) != PREFETCH_BATCHES or not all(same):
        raise RuntimeError(f"prefetch: {len(staged)} batches, equal to "
                           f"their source in order: {same}")
    del staged
    losses = {}
    with BG.solo_group(device):
        for feed in ("prefetched", "direct"):
            model = BR.make_model(args, device).train()
            step = BR.build_step(model, flat_mesh(n=1))
            if feed == "direct":
                batch = BR.make_batch(args, device)
            else:
                with Prefetcher(iter([BR.host_batch(args)]), depth=1,
                                place=to_device(device)) as pf:
                    x, y = next(pf)
                batch = (x.permute(0, 3, 1, 2), y)
            losses[feed] = float(step(batch))
            del model, step, batch
    if losses["prefetched"] != losses["direct"]:
        raise RuntimeError(f"a step fed from the Prefetcher: {losses}")
    return {"batches": PREFETCH_BATCHES, "batch_mb": nbytes / 1e6,
            "bit_identical_in_order": True,
            "h2d_gb_per_s": nbytes / h2d_ms / 1e6,
            "pipeline_gb_per_s": PREFETCH_BATCHES * nbytes / wall / 1e9,
            "step_loss": losses}


# bf16 against f32 on the card, BERT-base: the logits and the loss of one
# forward, the gradients of one backward (relative L2 over all of them)
BERT_TOL = {"logits": 5e-2, "loss": 1e-2, "grads": 5e-2}
BERT_BATCH, BERT_SEQ = 8, 512


def phase_bert_base(device) -> dict:
    """One forward and one backward of BERT-base at full width (12 layers,
    768 wide, 30522 tokens, 8 x 512 tokens, the last row padded from 384
    on) in bf16 against f32 on the card, from the same seeded weights;
    the loss predicts each input token, as the JAX tests train it."""
    from kungfu_tpu_torch.models.bert import bert_base
    rng = np.random.RandomState(4)
    toks = torch.from_numpy(rng.randint(0, 30522, (BERT_BATCH, BERT_SEQ))
                            ).to(device)
    mask = torch.ones(BERT_BATCH, BERT_SEQ, dtype=torch.bool, device=device)
    mask[-1, 384:] = False
    f32 = bert_base(dtype=torch.float32).to(device).init(0)
    bf = bert_base(dtype=torch.bfloat16).to(device)
    bf.load_state_dict(f32.state_dict())
    res = {}
    for tag, model in (("f32", f32), ("bf16", bf)):
        params = list(model.parameters())

        def fwd_bwd():
            logits = model(toks, mask)
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   toks.reshape(-1))
            return logits, loss, torch.autograd.grad(loss, params)

        fwd_bwd()                                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, loss, grads = fwd_bwd()
        torch.cuda.synchronize()
        res[tag] = {"ms": (time.perf_counter() - t0) * 1e3,
                    "logits": logits.detach(), "loss": float(loss.detach()),
                    "grads": torch.cat([g.float().reshape(-1)
                                        for g in grads])}
    a, b = res["bf16"], res["f32"]
    errs = {"logits": float((a["logits"] - b["logits"]).abs().max()
                            / b["logits"].abs().max()),
            "loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grads": float((a["grads"] - b["grads"]).norm()
                           / b["grads"].norm())}
    if not all(math.isfinite(v) and v <= BERT_TOL[k]
               for k, v in errs.items()):
        raise RuntimeError(f"BERT-base bf16 vs f32 {errs}, limits "
                           f"{BERT_TOL}")
    return {"batch": BERT_BATCH, "seq": BERT_SEQ,
            "params": sum(p.numel() for p in f32.parameters()),
            "bf16_vs_f32": errs, "limits": BERT_TOL,
            "loss": {"f32": b["loss"], "bf16": a["loss"]},
            "fwd_bwd_wall_ms": {"f32": b["ms"], "bf16": a["ms"]}}


# ------------------------------------------ phase 11: the optimizer family
# card against CPU, bert_tiny f32 (TF32 off), 3 gloo ranks, 5 steps:
# losses (relative), the monitors' statistic (relative to its largest
# value: S_est amplifies the norms' rounding) and the parameters, as
# |card - cpu| / |cpu - init| in L2 over every parameter of a rank.  Under
# SGD the parameters follow the gradients' rounding (~1e-6); under Adam an
# element whose gradient is within rounding of 0 (the key biases: a
# constant shift of a query's scores) steps by +-lr on that rounding, so
# the Adam chain has its own limit: between its sound reading (2.5e-3)
# and the faults planted in it (the dropped pull, and GNS feeding Adam
# the mean gradient where SMA needs the local one), each read in this
# phase
OPT_TOL = {"loss": 1e-4, "stat": 1e-3, "params": 1e-3, "params_adam": 1e-2}
OPT_STEPS = 5
OPT_LR = {"sgd": 0.1, "adam": 1e-3, "adam_base": 1e-4}
MLM_MASK_ID = 0


def _opt_chain(name: str, leaves, world: int, lr: dict, group=None):
    """The optimizer of run ``name`` over ``leaves``; GNS's batch_size is
    8 rows a rank."""
    from kungfu_tpu_torch import optimizers as O

    def sgd():
        return torch.optim.SGD(leaves, lr=lr["sgd"])

    def adam():
        return torch.optim.Adam(leaves, lr=lr["adam"], betas=(0.9, 0.999),
                                eps=1e-8)

    return {
        "sync_sgd": lambda: O.synchronous_sgd(adam(), group, fusion=True),
        "sma_gns_local_adam": lambda: O.synchronous_averaging(
            O.gradient_noise_scale(adam(), 8, group, apply="local"), 0.1,
            group),
        "sma_gns_local": lambda: O.synchronous_averaging(
            O.gradient_noise_scale(sgd(), 8, group, apply="local"), 0.1,
            group),
        "gns_mean": lambda: O.gradient_noise_scale(sgd(), 8, group),
        "gns_mean_adam": lambda: O.gradient_noise_scale(adam(), 8, group),
        "variance": lambda: O.gradient_variance(sgd(), group),
        "variance_adam": lambda: O.gradient_variance(adam(), group),
        "adaptive": lambda: O.adaptive_sgd(sgd(), 2, group=group),
        "adaptive_adam": lambda: O.adaptive_sgd(adam(), 2, group=group),
        "pair": lambda: O.pair_averaging(sgd(), world, group),
        "pair_adam": lambda: O.pair_averaging(adam(), world, group),
    }[name]()


def _params_limit(name: str) -> float:
    return OPT_TOL["params_adam" if name.endswith("adam") else "params"]


@contextlib.contextmanager
def planted(fault):
    """A fault planted in this process for the duration of the block:
    ``"reversed"``, the exchange sends to rank - shift; ``"no_pull"``,
    SMA's pull is zero; ``"apply_mean"``, a noise-scale monitor built in
    the block feeds its base the mean gradient whatever its ``apply``."""
    from kungfu_tpu_torch import optimizers as O
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.optimizers import sma
    ring, pull, gns = C.ring_exchange, sma.pull_toward, O.gradient_noise_scale
    if fault == "reversed":
        C.ring_exchange = lambda x, g, s, n: ring(x, g, -s, n)
    elif fault == "no_pull":
        sma.pull_toward = lambda params, target, coef: [
            torch.zeros_like(t) for t in target]
    elif fault == "apply_mean":
        O.gradient_noise_scale = lambda *a, **k: gns(
            *a, **dict(k, apply="mean"))
    try:
        yield
    finally:
        C.ring_exchange, sma.pull_toward = ring, pull
        O.gradient_noise_scale = gns


def _flat_params(params) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1).cpu()
                      for t in tree_leaves(params)])


def _spawn(argvs, timeout: float, logs: str) -> None:
    """Run one process per argv (each in a session of its own) from this
    file's directory, output to ``logs``/<i>.log; a process that fails or
    outlives ``timeout`` fails the phase; every process group is killed
    on the way out."""
    here = os.path.dirname(os.path.abspath(__file__))
    i, code = launch(argvs, dict(os.environ, PYTHONPATH=here), here,
                     timeout, logs, sessions=True)
    if i is not None:
        with open(os.path.join(logs, f"{i}.log")) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"process {i} of {len(argvs)}: "
                           f"{'timeout' if code is None else f'exit {code}'}"
                           f"\n{tail}")


def _worker_argv(fn: str, rank: int, world: int, tmp: str) -> list:
    return [sys.executable, "-c", f"import chip_smoke as S; "
            f"S.{fn}({rank}, {world}, {tmp!r})"]


def _join(rank: int, world: int, tmp: str, threads: int = 2):
    """A worker rank: the card (TF32 off), a gloo group through the
    FileStore in ``tmp``."""
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    device = resolve_device("cuda")
    torch.set_num_threads(threads)
    init_process_group_file(os.path.join(tmp, "store"), rank, world, "gloo")
    return device


CARD_VS_CPU = {  # run -> the statistic it reads
    "sma_gns_local_adam": "noise_scale", "sma_gns_local": "noise_scale",
    "gns_mean": "noise_scale", "variance": "variance", "adaptive": None,
    "pair": None}
CARD_VS_CPU_FAULTS = (("pair", "reversed"), ("sma_gns_local", "no_pull"),
                      ("sma_gns_local_adam", "no_pull"),
                      ("sma_gns_local_adam", "apply_mean"))


def opt_card_vs_cpu_worker(rank: int, world: int, tmp: str) -> None:
    """One rank of ``optimizers_card_vs_cpu``: every run on the card and
    on the CPU from the same weights and batches, the planted faults on
    the card."""
    import torch.distributed as dist
    from kungfu_tpu_torch.examples import convergence_bert as CB
    from kungfu_tpu_torch.examples.bert_sma_gns import mlm_loss_fn
    from kungfu_tpu_torch.models.bert import bert_tiny
    from kungfu_tpu_torch.training import build_train_step
    _join(rank, world, tmp)
    base = bert_tiny(vocab_size=CB.VOCAB, max_len=CB.SEQ,
                     dtype=torch.float32).init(0)
    init = _flat_params(dict(base.named_parameters()))
    bank, rng = CB.template_bank(), np.random.RandomState(0)
    batches = [CB.sample_batch(bank, rng, 8 * world)
               for _ in range(OPT_STEPS)]
    res = {"init": init}
    runs = [(n, d, None) for n in CARD_VS_CPU for d in ("cuda", "cpu")]
    runs += [(n, "cuda", f) for n, f in CARD_VS_CPU_FAULTS]
    for name, dev, fault in runs:
        model = copy.deepcopy(base).to(dev)
        params = dict(model.named_parameters())
        losses, stats = [], []
        with planted(fault):
            opt = _opt_chain(name, tree_leaves(params), world, OPT_LR)
            step = build_train_step(mlm_loss_fn(model), opt, params)
            for b in batches:
                losses.append(step(tuple(torch.from_numpy(a).to(dev)
                                         for a in b)))
                if CARD_VS_CPU[name]:
                    stats.append(getattr(opt, CARD_VS_CPU[name]))
        key = f"{name}/{dev}" + (f"/{fault}" if fault else "")
        res[key] = {"loss": torch.stack(losses).cpu(),
                    "stat": torch.stack(stats).cpu() if stats else None,
                    "params": _flat_params(params)}
    torch.save(res, os.path.join(tmp, f"r{rank}.pt"))
    dist.destroy_process_group()


def _card_vs_cpu_errs(res: list, name: str, key: str) -> dict:
    """The three measures of run ``key`` (on the card) against ``name``
    on the CPU, the worst over the ranks."""
    out = {"loss": 0.0, "stat": 0.0, "params": 0.0}
    for r in res:
        got, want = r[key], r[f"{name}/cpu"]
        out["loss"] = max(out["loss"], float(
            ((got["loss"] - want["loss"]).abs() / want["loss"].abs()).max()))
        if want["stat"] is not None:
            out["stat"] = max(out["stat"], float(
                (got["stat"] - want["stat"]).abs().max()
                / want["stat"].abs().max()))
        out["params"] = max(out["params"], float(
            (got["params"] - want["params"]).norm()
            / (want["params"] - r["init"]).norm()))
    return out


def phase_optimizers_card_vs_cpu(device) -> dict:
    """The optimizer family on the card against the CPU: bert_tiny (vocab
    512, seq 64, f32) at 3 gloo ranks sharing the card and at 3 on the
    CPU (the same processes, the same seeded weights and batches of
    ``convergence_bert``, 8 rows a rank), 5 steps of SMA(GNS local) over
    Adam (the examples' chain) and over SGD, GNS mean, the variance,
    adaptive SGD (switch at step 2) and pair averaging.  Gates: every
    run within ``OPT_TOL``; the faults planted in the workers (the
    reversed exchange in pair averaging, SMA's dropped pull in both SMA
    chains, GNS's mean gradient in the Adam chain) above its chain's
    parameter limit."""
    world = 3
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _spawn([_worker_argv("opt_card_vs_cpu_worker", r, world, tmp)
                for r in range(world)], 600, tmp)
        res = [torch.load(os.path.join(tmp, f"r{r}.pt"))
               for r in range(world)]
    errs, bad = {}, {}
    for name in CARD_VS_CPU:
        e = errs[name] = _card_vs_cpu_errs(res, name, f"{name}/cuda")
        lim = dict(OPT_TOL, params=_params_limit(name))
        over = {k: v for k, v in e.items()
                if not (math.isfinite(v) and v <= lim[k])}
        if over:
            bad[name] = over
    faults = {f"{name}/{fault}": _card_vs_cpu_errs(
        res, name, f"{name}/cuda/{fault}")["params"]
        for name, fault in CARD_VS_CPU_FAULTS}
    missed = {k: v for k, v in faults.items()
              if not v > _params_limit(k.split("/")[0])}
    if bad or missed:
        raise RuntimeError(f"card vs CPU over the limits {OPT_TOL}: {bad}; "
                           f"planted faults read at or below their "
                           f"chain's parameter limit: {missed}")
    return {"ranks": world, "steps": OPT_STEPS, "errs": errs,
            "faults_params_err": faults, "limits": OPT_TOL,
            "seconds": time.perf_counter() - t0}


BERT_OPT_W1 = ("sync_sgd", "sma_gns_local_adam", "gns_mean_adam",
               "variance_adam", "adaptive_adam", "pair_adam")
BERT_OPT_2R = ("sma_gns_local_adam", "variance_adam", "adaptive",
               "pair_adam")


def _bert_base_mlm(device, seed: int, batch: int, n: int):
    """BERT-base (f32 masters, bf16 compute) and ``n`` seeded MLM batches
    of ``batch`` x 512 tokens, 15% masked."""
    from kungfu_tpu_torch.models.bert import bert_base
    model = bert_base(dtype=torch.bfloat16).to(device).init(0)
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n):
        tokens = rng.randint(1, 30522, (batch, BERT_SEQ))
        is_masked = rng.rand(*tokens.shape) < 0.15
        masked = np.where(is_masked, MLM_MASK_ID, tokens)
        batches.append(tuple(torch.from_numpy(a).to(device) for a in (
            tokens.astype(np.int32), masked.astype(np.int32),
            is_masked.astype(np.float32))))
    return model, batches


def phase_optimizers_bert_base_w1(device) -> dict:
    """The optimizer layer's own cost above synchronous SGD at full width:
    BERT-base (30522 vocab, 12 x 768, untied head) in a world of one
    (NCCL), MLM on 8 x 512 tokens, bf16 compute over f32 masters through
    ``build_train_step``; for sync SGD (fused all-reduce) and each
    wrapper, all over Adam: 1 warm-up and 5 timed steps (host clock,
    synchronised), one step under torch.profiler and one
    ``optimizer.step()`` alone under torch.profiler (launches, host wall,
    device time)."""
    from kungfu_tpu_torch.examples.bert_sma_gns import mlm_loss_fn
    from kungfu_tpu_torch.training import build_train_step
    torch.cuda.empty_cache()
    model, batches = _bert_base_mlm(device, 5, BERT_BATCH, 7)
    params = dict(model.named_parameters())
    init = {k: v.detach().clone() for k, v in params.items()}
    loss_fn = mlm_loss_fn(model)
    out = {}
    with BG.solo_group(device):
        for name in BERT_OPT_W1:
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(init[k])
            torch.cuda.reset_peak_memory_stats()
            opt = _opt_chain(name, tree_leaves(params), 1,
                             dict(OPT_LR, adam=OPT_LR["adam_base"]))
            step = build_train_step(loss_fn, opt, params,
                                    compute_dtype=torch.bfloat16)
            losses, times = [float(step(batches[0]))], []
            for b in batches[1:6]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(b)))
                times.append((time.perf_counter() - t0) * 1e3)
            _, prof = profile_run(lambda: step(batches[6]))
            prof.pop("top_kernels_ms")
            masters = tree_leaves(params)
            for m in masters:
                m.grad = torch.full_like(m, 1e-6)
            _, prof_opt = profile_run(opt.step)
            prof_opt.pop("top_kernels_ms")
            for m in masters:
                m.grad = None
            if not all(math.isfinite(x) for x in losses):
                raise RuntimeError(f"{name}: losses {losses}")
            out[name] = {"step_ms": statistics.median(times),
                         "step_ms_all": times, "losses": losses,
                         "step_profile": prof, "optimizer_step": prof_opt,
                         "peak_memory_gb":
                             torch.cuda.max_memory_allocated() / 1e9}
            del opt, step
    base = out["sync_sgd"]
    for name, rec in out.items():
        rec["step_ms_over_sync_sgd"] = rec["step_ms"] - base["step_ms"]
        rec["optimizer_launches_over_sync_sgd"] = (
            rec["optimizer_step"]["launches"]
            - base["optimizer_step"]["launches"])
    return {"batch": BERT_BATCH, "seq": BERT_SEQ,
            "params": sum(v.numel() for v in params.values()),
            "lr_adam": OPT_LR["adam_base"], "runs": out}


def opt_bert_base_2r_worker(rank: int, world: int, tmp: str) -> None:
    """One rank of ``optimizers_bert_base_2r``: each run's step wall, the
    collectives' wall and bytes (every all-reduce and exchange timed,
    synchronised, in this process; an exchange's bytes are those sent),
    peak memory, the monitors' statistics, and the replica checks
    (all-reduce MAX and MIN of the parameters, outside the timed steps:
    SMA's after its last step, adaptive SGD's after each step from the
    switch on)."""
    import torch.distributed as dist
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.examples.bert_sma_gns import mlm_loss_fn
    from kungfu_tpu_torch.training import (broadcast_variables,
                                           build_train_step)
    device = _join(rank, world, tmp)
    model, batches = _bert_base_mlm(device, 5, BERT_BATCH * world, 4)
    params = dict(model.named_parameters())
    broadcast_variables(params)
    init = {k: v.detach().clone() for k, v in params.items()}
    loss_fn = mlm_loss_fn(model)
    acc = {"on": False, "s": 0.0, "bytes": 0}
    all_reduce = dist.all_reduce

    def timed(fn, nbytes):
        def call(*a, **k):
            if not acc["on"]:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc["s"] += time.perf_counter() - t0
            acc["bytes"] += nbytes(*a)
            return out
        return call

    dist.all_reduce = timed(all_reduce,
                            lambda t, *a: t.numel() * t.element_size())
    C.ring_exchange = timed(C.ring_exchange, lambda x, *a: sum(
        t.numel() * t.element_size() for t in tree_leaves(x)))

    def spread():
        """max |p_0 - p_1| and max(|p_0 - p_1| - 1e-4 min |p|) over all
        parameters (two ranks)."""
        flat = torch.cat([t.detach().reshape(-1) for t in params.values()])
        hi, lo = flat.clone(), flat.clone()
        all_reduce(hi, op=dist.ReduceOp.MAX)
        all_reduce(lo, op=dist.ReduceOp.MIN)
        gap = hi - lo
        return (float(gap.max()),
                float((gap - 1e-4 * torch.minimum(hi.abs(), lo.abs())).max()))

    out = {}
    for name in BERT_OPT_2R:
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(init[k])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt = _opt_chain(name, tree_leaves(params), world,
                         dict(OPT_LR, adam=OPT_LR["adam_base"]))
        step = build_train_step(loss_fn, opt, params,
                                compute_dtype=torch.bfloat16)
        stat = {"sma_gns_local_adam": "noise_scale",
                "variance_adam": "variance"}.get(name)
        rec = {"step_ms": [], "collective_ms": [], "bytes": [],
               "losses": [], "stat": [], "spread": []}
        for t, b in enumerate(batches):
            acc.update(on=t > 0, s=0.0, bytes=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec["losses"].append(float(step(b)))
            if t > 0:
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["collective_ms"].append(acc["s"] * 1e3)
                rec["bytes"].append(acc["bytes"])
            acc["on"] = False
            if stat:
                rec["stat"].append(float(getattr(opt, stat)))
            if ((name == "adaptive" and t >= 2) or (
                    name == "sma_gns_local_adam" and t == len(batches) - 1)):
                rec["spread"].append(spread())
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[name] = rec
        del opt, step
    with open(os.path.join(tmp, f"r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_optimizers_bert_base_2r(device) -> dict:
    """BERT-base (as ``optimizers_bert_base_w1``, 8 x 512 tokens a rank)
    at 2 processes sharing the card over gloo: SMA(GNS(Adam, local)), the
    variance over Adam, adaptive SGD (switch at step 2) and pair
    averaging over Adam, 1 warm-up and 3 timed steps each.  Gates:
    ``noise_scale`` and ``variance`` finite and equal on both ranks; SMA's
    replicas not identical; adaptive's replicas within rtol 1e-4, atol
    1e-6 of each other from the switch on.  Gloo stages every all-reduce
    of a CUDA tensor through the host, so the collectives' wall is an
    artifact of two ranks on one card, not the optimizers' cost."""
    world = 2
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        _spawn([_worker_argv("opt_bert_base_2r_worker", r, world, tmp)
                for r in range(world)], 900, tmp)
        res = []
        for r in range(world):
            with open(os.path.join(tmp, f"r{r}.json")) as f:
                res.append(json.load(f))
    r0, r1 = res
    for name in ("sma_gns_local_adam", "variance_adam"):
        a, b = r0[name]["stat"], r1[name]["stat"]
        if a != b or not all(math.isfinite(x) for x in a):
            raise RuntimeError(f"{name}: statistics {a} on rank 0, {b} on "
                               f"rank 1")
    if r0["sma_gns_local_adam"]["spread"][-1][0] <= 0:
        raise RuntimeError("SMA's replicas are identical")
    # steps 0, 1 average, step 2 switches; the spread after steps 2 and 3
    excess = [s[1] for s in r0["adaptive"]["spread"]]
    if not all(e <= 1e-6 for e in excess):
        raise RuntimeError(f"adaptive SGD after the switch: replicas apart "
                           f"by {excess} beyond rtol 1e-4 (atol 1e-6)")
    runs = {name: {"step_ms": [r[name]["step_ms"] for r in res],
                   "collective_ms": [r[name]["collective_ms"] for r in res],
                   "bytes_a_step": r0[name]["bytes"][-1],
                   "peak_memory_gb": [r[name]["peak_memory_gb"]
                                      for r in res],
                   "losses": r0[name]["losses"], "stat": r0[name]["stat"],
                   "spread": r0[name]["spread"]}
            for name in BERT_OPT_2R}
    return {"ranks": world, "backend": "gloo", "runs": runs,
            "adaptive_excess_after_switch": excess,
            "note": "collective wall: gloo stages CUDA tensors through the "
                    "host (two ranks on one card)"}


CONVERGENCE_RANKS = 8
README_CURVE = {"initial_loss": 6.76, "final_loss": 4.50,
                "source": "README.md:994, a CPU run of the JAX script "
                          "(2 processes x 4 lanes)"}


def phase_convergence_bert(device) -> dict:
    """The README's recorded convergence run on the card: ``python -m
    kungfu_tpu_torch.examples.convergence_bert --world 8 --batch-per-lane
    8 --steps 200 --backend gloo`` (8 ranks for its 2 processes x 4
    lanes, bf16), gated by the example's own ``--target 5.0``."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "convergence.json")
        t0 = time.perf_counter()
        _spawn([[sys.executable, "-m",
                 "kungfu_tpu_torch.examples.convergence_bert", "--world",
                 str(CONVERGENCE_RANKS), "--batch-per-lane", "8",
                 "--steps", "200", "--backend", "gloo", "--json", out]],
               900, tmp)
        wall = time.perf_counter() - t0
        with open(out) as f:
            rec = json.load(f)
        with open(os.path.join(tmp, "0.log")) as f:
            line = [ln for ln in f.read().splitlines()
                    if ln.startswith("CONVERGENCE ")][-1]
    if not rec["reached"] or rec["final_loss"] > rec["target"]:
        raise RuntimeError(f"convergence_bert: {line}")
    return {"line": line, "curve": rec["curve"], "wall_s": wall,
            "readme": README_CURVE}


# ------------------------------------------- phase 12: the elastic plane
ELASTIC_NCCL_VERSIONS = 3
# memory_reserved, and the card's used memory (mem_get_info, which also
# counts what NCCL allocates outside the cache: a communicator the
# teardown failed to free), after the last NCCL re-formation may exceed
# the first's by at most this (the same tensors at every version come
# from the cache)
ELASTIC_NCCL_MARGIN = 16 << 20
ELASTIC_SCHEDULE = "2:3,4:3,3:3"
# depth cut from the preset's 24 layers: at 24 the two elastic phases took
# 203-212 s on the H100, over their 180 s budget (PERF.md, PR 12); 6, not
# 12, leaves the whole script room for the tp serving phases
ELASTIC_LAYERS = 6
ELASTIC_ROWS = 12                # global batch, sequences of 2048 tokens
ELASTIC_SAVE_AT = 6              # the checkpoint the fault job resumes
# |elastic - one-process| mean loss of a step (bf16 compute: the ranks
# round their block's mean gradient, the one process the batch's)
ELASTIC_LOSS_TOL = 2e-2
# the fault job: 1 rank for a step, grown to 4 (rank 1 keeps its own
# weights, rank 2 gets them with fresh Adam moments), a step, then every
# rank resumes the sound run's step-6 checkpoint (which repairs both),
# the cluster shrinks 4 -> 3 and trains steps 6-8 with rank 1, a
# survivor, still on the 4-rank block
ELASTIC_FAULT_JOB = ("1:1,4:1,3:7", {1: "own_init,old_block",
                                     2: "fresh_moments"}, 2)
# ``--commit-cost``: a cadence longer than any job, so only the
# constructor commits
COMMITS_OFF = 1 << 20


def elastic_args():
    """The 470m preset at full width, ``ELASTIC_LAYERS`` deep, flash
    attention (K1-K4)."""
    return BG.parse_args(["--preset", "470m", "--device", "cuda",
                          "--attn", "flash", "--n-layers",
                          str(ELASTIC_LAYERS)])


def elastic_batch(i: int, device):
    """Global batch ``i``: row r holds 2049 seeded tokens drawn from the
    first 2^(4+r) ids, so rows differ in how fast their loss falls (a rank
    that trains the wrong rows changes the mean loss)."""
    rng = np.random.RandomState(1000 + i)
    rows = np.stack([rng.randint(0, 2 ** (4 + r), 2049)
                     for r in range(ELASTIC_ROWS)]).astype(np.int32)
    t = torch.from_numpy(rows).to(device)
    return t[:, :-1].contiguous(), t[:, 1:].contiguous()


def elastic_optimizer(leaves, n, group=None):
    """Sync-SGD AdamW (``benchmarks.gpt``'s settings), one fused
    all-reduce per dtype."""
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    return synchronous_sgd(torch.optim.AdamW(
        leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        group, fusion=True)


def elastic_checksums(trainer) -> dict:
    """Which ranks' parameters and Adam moments differ from rank 0's, bit
    for bit: each rank sums every leaf's bits (int32 words, in int64) and
    the vectors are gathered; also the count of differing leaves."""
    import torch.distributed as dist
    leaves = trainer._leaves()
    zero = torch.zeros((), dtype=torch.int64, device=leaves[0].device)
    sums = [t.detach().view(torch.int32).sum(dtype=torch.int64)
            for t in leaves]
    moments = 0
    for t in leaves:
        st = trainer.optimizer.state.get(t, {})
        for key in ("exp_avg", "exp_avg_sq"):
            v = st.get(key)
            moments += v is not None
            sums.append(zero if v is None else
                        v.view(torch.int32).sum(dtype=torch.int64))
    vec = torch.stack(sums).cpu()
    got = [torch.empty_like(vec) for _ in range(trainer.n)]
    dist.all_gather(got, vec)
    p = len(leaves)
    return {"version": trainer.version, "n": trainer.n,
            "moments": moments,
            "params_differ": [int((g[:p] != got[0][:p]).sum()) for g in got],
            "moments_differ": [int((g[p:] != got[0][p:]).sum())
                               for g in got]}


def elastic_gpt_worker() -> None:
    """One rank of ``elastic_gpt_470m``, started by the port's watcher
    (``python -c "import chip_smoke as S; S.elastic_gpt_worker()"`` with
    the worker flags): the 470m GPT under DistributedElasticTrainer (gloo,
    CUDA tensors), rank 0 proposing each stage of ``--schedule``;
    bit-for-bit checks of the replicas when it joins, after every resize
    and at the end; one JSON record of its run."""
    import argparse
    import kungfu_tpu_torch as kft
    from kungfu_tpu_torch import distributed as D
    from kungfu_tpu_torch import training as T
    from kungfu_tpu_torch.checkpoint import Checkpointer
    from kungfu_tpu_torch.elastic import DistributedElasticTrainer, StepSchedule
    from kungfu_tpu_torch.launcher import env as E
    ap = argparse.ArgumentParser()
    E.add_args(ap)
    for flag in ("--out", "--schedule", "--fault", "--ckpt"):
        ap.add_argument(flag, default="")
    ap.add_argument("--save-at", type=int, default=-1)
    ap.add_argument("--restore-after", type=int, default=-1)
    ap.add_argument("--snapshot-every", type=int, default=1)
    ns = ap.parse_args(sys.argv[1:])
    we = E.install(E.from_args(ns))
    rank = we.rank()
    device = resolve_device("cuda")
    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    args = elastic_args()
    cfg = BG.make_config(args)
    params = G.init_params(torch.Generator(device=device).manual_seed(rank),
                           cfg)
    rec = {"rank": rank, "join_version": we.cluster_version, "fault":
           ns.fault, "checks": [], "steps": [], "resizes": []}
    torch.cuda.reset_peak_memory_stats()
    real_bcast, real_slice = D.broadcast_tree, T._local_slice
    faults = ns.fault.split(",")
    if "own_init" in faults or "fresh_moments" in faults:
        def bcast(tree, group=None, root=0):
            got = real_bcast(tree, group, root)
            own = {"params": params} if "own_init" in faults else got
            return {**got, **own, "opt": None}
        D.broadcast_tree = bcast
    if "old_block" in faults:
        def old_block(batch, r, world):      # the 4-rank block at 3 ranks
            return real_slice(batch, r, 4 if world == 3 else world)
        T._local_slice = old_block
    t0 = time.perf_counter()
    trainer = DistributedElasticTrainer(
        BG.make_loss_fn(args, cfg), elastic_optimizer, params,
        backend="gloo", compute_dtype=cfg.dtype, microbatch=1,
        snapshot_every=ns.snapshot_every)
    rec["construct_s"] = time.perf_counter() - t0
    rec["received_bytes"] = trainer.last_sync_bytes
    D.broadcast_tree = real_bcast
    rec["checks"].append({"at": "join", **elastic_checksums(trainer)})
    reform = trainer._reform

    def reform_and_check(peers, version):
        n0 = trainer.n
        out = reform(peers, version)
        rec["resizes"].append({"from": n0, "to": len(peers), "version":
                               version, "seconds": trainer.last_resize_seconds,
                               "sent_bytes": trainer.last_sync_bytes})
        if not kft.detached():
            rec["checks"].append({"at": "resize",
                                  **elastic_checksums(trainer)})
        return out
    trainer._reform = reform_and_check
    ck = Checkpointer(ns.ckpt) if ns.ckpt else None
    schedule = StepSchedule.parse(ns.schedule)
    for name in FA.launches:
        FA.launches[name] = 0
    microbatches = 0
    while trainer.step_count < schedule.total_steps():
        if trainer.step_count == ns.restore_after:
            trainer.restore_checkpoint(ck)
            rec["checks"].append({"at": "restore",
                                  **elastic_checksums(trainer)})
        i = trainer.step_count
        if i == ns.save_at:
            trainer.save_checkpoint(ck)
        want = schedule.size_at(i)
        if rank == 0 and want != trainer.n:
            if not trainer.propose_new_size(want):
                raise RuntimeError(f"proposal of {want} ranks refused")
        batch = elastic_batch(i, device)
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        if loss is None:
            break
        rec["steps"].append({"step": i, "n": trainer.n, "loss": loss,
                             "seconds": time.perf_counter() - t0})
        microbatches += ELASTIC_ROWS // trainer.n
    rec["detached"] = kft.detached()
    if not rec["detached"]:
        rec["checks"].append({"at": "end", **elastic_checksums(trainer)})
        rec["trained_samples"] = trainer.trained_samples
    if ck is not None:
        ck.wait()
    rec["launches"] = dict(FA.launches)
    rec["microbatches"] = microbatches
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(ns.out, f"r{rank}_v{we.cluster_version}.json"),
              "w") as f:
        json.dump(rec, f)
    trainer.shutdown()


def elastic_job(schedule: str, tmp: str, name: str, faults=None,
                extra=(), timeout: float = 600) -> list:
    """Run one elastic job through the port's config server and watcher:
    a cluster of the schedule's first size, every rank an
    :func:`elastic_gpt_worker`.  Returns the workers' records and the
    watcher's exit codes."""
    from kungfu_tpu_torch.elastic import ConfigServer, StepSchedule
    from kungfu_tpu_torch.launcher import env as E
    from kungfu_tpu_torch.launcher.watch import watch_run
    from kungfu_tpu_torch.plan import Cluster, HostList
    out = os.path.join(tmp, name)
    os.makedirs(out)
    size0 = StepSchedule.parse(schedule).size_at(0)
    server = ConfigServer().start()
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        server.put_cluster(Cluster.from_hostlist(
            HostList.parse("127.0.0.1:4"), size0))

        def argv_for(rank, cluster, version):
            fault = (faults or {}).get(rank)
            return [sys.executable, "-c",
                    "import chip_smoke as S; S.elastic_gpt_worker()",
                    "--out", out, "--schedule", schedule, *extra,
                    *(["--fault", fault] if fault else []),
                    *E.worker_argv(rank, cluster.workers, version,
                                   server.url, os.path.join(tmp, "rdzv_"
                                                            + name))]
        exits = watch_run(server, argv_for, out,
                          env=dict(os.environ, PYTHONPATH=here), cwd=here,
                          timeout=timeout)
    finally:
        server.stop()
    recs = []
    for fn in sorted(os.listdir(out)):
        if fn.endswith(".json"):
            with open(os.path.join(out, fn)) as f:
                recs.append(json.load(f))
    return recs, exits


def elastic_reference(device) -> dict:
    """One process over the same global batches from rank 0's weights
    (``benchmarks.gpt``'s step: 12 microbatches of one sequence)."""
    from kungfu_tpu_torch.training import build_train_step
    args = elastic_args()
    cfg = BG.make_config(args)
    steps = sum(int(s.split(":")[1]) for s in ELASTIC_SCHEDULE.split(","))
    losses, seconds = [], []
    t_start = time.perf_counter()
    with BG.solo_group(device):
        params = G.init_params(torch.Generator(device=device).manual_seed(0),
                               cfg)
        opt = elastic_optimizer(tree_leaves(params), 1)
        step = build_train_step(BG.make_loss_fn(args, cfg), opt, params,
                                accum_steps=ELASTIC_ROWS,
                                compute_dtype=cfg.dtype)
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(elastic_batch(i, device))))
            seconds.append(time.perf_counter() - t0)
        del params, opt, step
    torch.cuda.empty_cache()
    return {"losses": losses, "step_seconds": seconds,
            "wall_s": time.perf_counter() - t_start}


def _elastic_bad_checks(recs) -> list:
    return [(r["rank"], c["at"], c["params_differ"], c["moments_differ"])
            for r in recs for c in r["checks"]
            if any(c["params_differ"]) or any(c["moments_differ"])
            or (c["at"] != "join" and c["moments"] == 0)]


def _elastic_loss_gap(recs, ref) -> list:
    r0 = [r for r in recs if r["rank"] == 0 and r["steps"]]
    return [abs(s["loss"] - ref[s["step"]]) for r in r0 for s in r["steps"]]


def _step_seconds_by_ranks(r0) -> dict:
    """Rank 0's step seconds of an ``ELASTIC_SCHEDULE`` job by cluster
    size, without each stage's first step (which holds its resize)."""
    by_n = {}
    for s in r0["steps"]:
        if s["step"] not in (0, 3, 6):
            by_n.setdefault(s["n"], []).append(s["seconds"])
    return by_n


def phase_elastic_commit_cost(device) -> dict:
    """What the commits cost ``elastic_gpt_470m``: its sound schedule (no
    checkpoint) with a commit at every step (the trainer's default) and
    with none after the constructor's, in the order on, off, off, on.
    Each job's step seconds by cluster size, and the mean of each size
    over the two jobs of a setting."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, every in enumerate((1, COMMITS_OFF, COMMITS_OFF, 1)):
            t0 = time.perf_counter()
            recs, exits = elastic_job(ELASTIC_SCHEDULE, tmp, f"every_{i}",
                                      extra=("--snapshot-every", str(every)))
            wall = time.perf_counter() - t0
            bad = _elastic_bad_checks(recs)
            if bad or sorted(exits.values()) != [0] * 4:
                raise RuntimeError(f"commit-cost job {i} (snapshot_every="
                                   f"{every}): exits {exits}, replicas "
                                   f"differ {bad}")
            r0 = [r for r in recs if r["rank"] == 0][0]
            runs.append({"snapshot_every": every, "wall_s": wall,
                         "step_seconds_by_ranks": _step_seconds_by_ranks(r0),
                         "peak_memory_gb": {
                             f"r{r['rank']}_v{r['join_version']}":
                             r["peak_memory_gb"] for r in recs}})
    mean = {}
    for setting, every in (("commits", 1), ("no_commits", COMMITS_OFF)):
        by_n = {}
        for run in runs:
            if run["snapshot_every"] == every:
                for n, secs in run["step_seconds_by_ranks"].items():
                    by_n.setdefault(n, []).extend(secs)
        mean[setting] = {n: sum(v) / len(v) for n, v in by_n.items()}
    return {"schedule": ELASTIC_SCHEDULE, "runs": runs,
            "mean_step_seconds": mean,
            "commit_share": {n: mean["commits"][n] / mean["no_commits"][n] - 1
                             for n in mean["commits"]}}


def phase_elastic_gpt_470m(device, ref: dict) -> dict:
    """The 470m GPT resized 2 -> 4 -> 3 while it trains (see
    :func:`elastic_gpt_worker`), ranks sharing the card over gloo, held
    against one process over the same batches (``ref``,
    :func:`elastic_reference`); then the planted faults."""
    torch.cuda.empty_cache()
    ref_s = ref["wall_s"]
    steps = len(ref["losses"])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        recs, exits = elastic_job(ELASTIC_SCHEDULE, tmp, "sound", extra=(
            "--ckpt", ckpt, "--save-at", str(ELASTIC_SAVE_AT)))
        sound_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sched, faults, after = ELASTIC_FAULT_JOB
        frecs, _ = elastic_job(sched, tmp, "faults", faults, extra=(
            "--ckpt", ckpt, "--restore-after", str(after)))
        faults_s = time.perf_counter() - t0
    # the sound run
    bad = _elastic_bad_checks(recs)
    if bad:
        raise RuntimeError(f"replicas differ (rank, at, params, moments): "
                           f"{bad}")
    if sorted(exits.values()) != [0] * 4 or len(recs) != 4:
        raise RuntimeError(f"expected 4 workers exiting 0: {exits}")
    left = [r for r in recs if r["detached"]]
    if [r["rank"] for r in left] != [3]:
        raise RuntimeError(f"detached: {[r['rank'] for r in left]}")
    alive = [r for r in recs if not r["detached"]]
    samples = {r["rank"]: r["trained_samples"] for r in alive}
    if set(samples.values()) != {steps * ELASTIC_ROWS}:
        raise RuntimeError(f"trained samples {samples}")
    gap = _elastic_loss_gap(recs, ref["losses"])
    if len(gap) != steps or max(gap) > ELASTIC_LOSS_TOL:
        raise RuntimeError(f"losses apart from one process by {gap} "
                           f"(limit {ELASTIC_LOSS_TOL})")
    for r in recs:
        need = ELASTIC_LAYERS * r["microbatches"]
        short = {k: v for k, v in r["launches"].items() if v < need}
        if short:
            raise RuntimeError(f"rank {r['rank']}: flash kernels launched "
                               f"{short}, needed {need}")
    # the planted faults
    grew = [c for r in frecs if r["rank"] == 0 for c in r["checks"]
            if c["at"] == "resize"][0]
    caught = {fault: {"rank": rank,
                      "params_differ": grew["params_differ"][rank],
                      "moments_differ": grew["moments_differ"][rank]}
              for rank, fault in ((1, "own_init"), (2, "fresh_moments"))}
    if not (caught["own_init"]["params_differ"] > 0
            and caught["fresh_moments"]["moments_differ"] > 0
            and caught["fresh_moments"]["params_differ"] == 0):
        raise RuntimeError(f"grow faults not caught as planted: {grew}")
    # the resumed part (steps 6-8): replicas equal again, losses apart
    resumed = [c for r in frecs for c in r["checks"]
               if c["at"] in ("restore", "end")]
    if any(any(c["params_differ"]) or any(c["moments_differ"])
           for c in resumed):
        raise RuntimeError(f"the resumed replicas differ: {resumed}")
    old_gap = [g for r in frecs if r["rank"] == 0 for s, g in zip(
        r["steps"], _elastic_loss_gap([r], ref["losses"]))
        if s["step"] >= ELASTIC_SAVE_AT]
    caught["old_block"] = {"rank": 1, "max_loss_gap": max(old_gap),
                           "loss_gaps": old_gap}
    if len(old_gap) != steps - ELASTIC_SAVE_AT or max(
            old_gap) <= ELASTIC_LOSS_TOL:
        raise RuntimeError(f"old-block fault not caught: loss gaps "
                           f"{old_gap} within {ELASTIC_LOSS_TOL}")
    r0 = [r for r in recs if r["rank"] == 0][0]
    return {
        "schedule": ELASTIC_SCHEDULE, "backend": "gloo",
        "layers": ELASTIC_LAYERS,
        "ranks_spawned": len(recs),
        "losses": [s["loss"] for s in r0["steps"]],
        "reference_losses": ref["losses"], "max_loss_gap": max(gap),
        "loss_tol": ELASTIC_LOSS_TOL,
        "reference_step_seconds": ref["step_seconds"],
        "resizes": r0["resizes"],
        "newcomers": [{"rank": r["rank"], "version": r["join_version"],
                       "construct_s": r["construct_s"],
                       "received_bytes": r["received_bytes"]}
                      for r in recs if r["join_version"] > min(
                          x["join_version"] for x in recs)],
        "step_seconds_by_ranks": _step_seconds_by_ranks(r0),
        "peak_memory_gb": {f"r{r['rank']}_v{r['join_version']}":
                           r["peak_memory_gb"] for r in recs},
        "trained_samples": samples, "checks": len(
            [c for r in recs for c in r["checks"]]),
        "launches_rank0": r0["launches"],
        "faults": caught,
        "wall_s": {"reference": ref_s, "sound": sound_s,
                   "faults": faults_s},
        "note": "step times: gloo stages every all-reduce of a CUDA tensor "
                "through the host (the ranks share one card); the first "
                "step of each stage holds its resize"}


# ---------------------------------------- phase 13: failure recovery
# three ranks on the card (gloo), a commit at every step; A: rank 2 is
# killed inside its gradient all-reduce of step 3; B: rank 0 is killed on
# its committer thread after the join of the commit of step 5 and before
# its publish (the new rank 0 is the old rank 1); C, planted: A's kill,
# and the survivors restore the previous commit's state with the newest
# commit's counters (trained_samples right, the trajectory wrong)
RECOVER_RANKS = 3
# steps cut from the 9 global batches, and C run beside B: with 9, 9 and
# 6 steps one after another the phase took 166 s on the H100, with 6, 7
# and 4 157 s, against its 150 s budget (PERF.md)
RECOVER_JOBS = {
    "A": {"victim": 2, "act": "kill_allreduce", "at": 3, "steps": 6},
    "B": {"victim": 0, "act": "kill_commit", "at": 5, "steps": 7},
    "C": {"victim": 2, "act": "kill_allreduce", "at": 3,
          "fault": "stale_state", "steps": 4},
}
# a collective that waits longer than this on a peer raises (the largest,
# the 1.0 GB gradient all-reduce staged through the host, takes ~1 s)
RECOVER_COLLECTIVE_S = 120.0


def elastic_recover_worker() -> None:
    """One rank of ``elastic_recover_470m``, started by the port's watcher
    (``python -c "import chip_smoke as S; S.elastic_recover_worker()"``
    with the worker flags): the 470m GPT under DistributedElasticTrainer
    (gloo, CUDA tensors, a commit at every step), the kill or the fault of
    ``--job`` planted here; bit-for-bit checks of the replicas after each
    recovery and at the end; one JSON record of its run, and one line a
    commit published (or a kill) in ``events.<rank>.jsonl``."""
    import argparse
    import signal
    import kungfu_tpu_torch as kft
    from kungfu_tpu_torch.elastic import DistributedElasticTrainer
    from kungfu_tpu_torch.launcher import env as E
    from kungfu_tpu_torch.optimizers import sync_sgd as SS
    ap = argparse.ArgumentParser()
    E.add_args(ap)
    ap.add_argument("--out", default="")
    ap.add_argument("--job", default="A")
    ns = ap.parse_args(sys.argv[1:])
    we = E.install(E.from_args(ns))
    rank0 = we.rank()
    job = RECOVER_JOBS[ns.job]
    steps = job["steps"]
    victim = rank0 == job["victim"] and we.cluster_version == 1
    device = resolve_device("cuda")
    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    args = elastic_args()
    cfg = BG.make_config(args)
    params = G.init_params(torch.Generator(device=device).manual_seed(rank0),
                           cfg)
    lock = threading.Lock()

    def note(kind, **kw):
        with lock, open(os.path.join(ns.out, f"events.{rank0}.jsonl"),
                        "a") as f:
            f.write(json.dumps({"kind": kind, "rank0": rank0, **kw}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def die():
        note("kill", time=time.time(),
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        os.kill(os.getpid(), signal.SIGKILL)

    trainer = None
    real_mean = SS.cross_replica_mean_gradients

    def mean_then_die(grads, group=None, fusion=False):
        # the all-reduce runs on a thread; the rank dies 50 ms into it
        if (victim and job["act"] == "kill_allreduce"
                and trainer.step_count == job["at"]):
            threading.Thread(target=real_mean, args=(grads, group, fusion),
                             daemon=True).start()
            time.sleep(0.05)
            die()
        return real_mean(grads, group, fusion)
    SS.cross_replica_mean_gradients = mean_then_die
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = DistributedElasticTrainer(
        BG.make_loss_fn(args, cfg), elastic_optimizer, params,
        backend="gloo", compute_dtype=cfg.dtype, microbatch=1,
        snapshot_every=1, collective_timeout_s=RECOVER_COLLECTIVE_S)
    rec = {"rank": rank0, "job": ns.job, "construct_s":
           time.perf_counter() - t0, "steps": [], "checks": []}
    previous = [None]
    real_publish = trainer._publish

    def publish(host, devices, progress):
        if (victim and job["act"] == "kill_commit"
                and progress[1] == job["at"]):
            die()                        # joined, not published
        previous[0] = trainer._committed
        real_publish(host, devices, progress)
        ps = trainer._committer.last
        note("commit", pair=list(progress), dispatch_s=ps.dispatch_s,
             join_s=ps.join_s, nbytes=ps.nbytes, time=time.time())
    trainer._publish = publish
    if job.get("fault") == "stale_state":
        trainer._committed_record = lambda: (*previous[0][:2],
                                             trainer._committed[2])
    for name in FA.launches:
        FA.launches[name] = 0
    microbatches = 0
    while trainer.step_count < steps:
        i = trainer.step_count
        if victim and job["act"] == "kill_commit" and i == job["at"]:
            time.sleep(300)              # the committer thread kills it
        seen = len(trainer.recoveries)
        t0 = time.perf_counter()
        loss = trainer.step(elastic_batch(i, device))
        if loss is None:
            break
        recovered = len(trainer.recoveries) > seen
        rec["steps"].append({"batch": i, "step": trainer.step_count,
                             "n": trainer.n, "loss": loss,
                             "seconds": time.perf_counter() - t0,
                             "recovered": recovered})
        microbatches += ELASTIC_ROWS // trainer.n
        if recovered:
            rec["checks"].append({"at": "recovery",
                                  **elastic_checksums(trainer)})
    rec["detached"] = kft.detached()
    if not rec["detached"]:
        rec["checks"].append({"at": "end", **elastic_checksums(trainer)})
        rec.update(trained_samples=trainer.trained_samples,
                   version=trainer.version, size=trainer.n)
    rec.update(recoveries=trainer.recoveries, launches=dict(FA.launches),
               microbatches=microbatches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    with open(os.path.join(ns.out, f"r{rank0}.json"), "w") as f:
        json.dump(rec, f)
    trainer.shutdown()


def recover_job(name: str, tmp: str, timeout: float = 300) -> dict:
    """Run job ``name`` of ``RECOVER_JOBS`` through the port's config
    server and watcher: the survivors' records, every rank's events, the
    watcher's exclusions and exit codes."""
    from kungfu_tpu_torch.elastic import ConfigServer
    from kungfu_tpu_torch.launcher import env as E
    from kungfu_tpu_torch.launcher.watch import watch_run
    from kungfu_tpu_torch.plan import Cluster, HostList
    out = os.path.join(tmp, name)
    os.makedirs(out)
    server = ConfigServer().start()
    here = os.path.dirname(os.path.abspath(__file__))
    exclusions = []
    t0 = time.perf_counter()
    try:
        server.put_cluster(Cluster.from_hostlist(
            HostList.parse("127.0.0.1:4"), RECOVER_RANKS))

        def argv_for(rank, cluster, version):
            return [sys.executable, "-c",
                    "import chip_smoke as S; S.elastic_recover_worker()",
                    "--out", out, "--job", name,
                    *E.worker_argv(rank, cluster.workers, version,
                                   server.url,
                                   os.path.join(tmp, "rdzv_" + name))]
        exits = watch_run(server, argv_for, out,
                          env=dict(os.environ, PYTHONPATH=here), cwd=here,
                          timeout=timeout, exclusions=exclusions)
        version, cluster = server.get_cluster()
    finally:
        server.stop()
    recs, events = [], []
    for fn in sorted(os.listdir(out)):
        with open(os.path.join(out, fn)) as f:
            if fn.endswith(".json"):
                recs.append(json.load(f))
            elif fn.endswith(".jsonl"):
                events += [json.loads(ln) for ln in f.read().splitlines()]
    return {"recs": recs, "events": events, "exits": exits,
            "exclusions": exclusions, "server_version": version,
            "server_size": cluster.size(),
            "wall_s": time.perf_counter() - t0}


def _effective(rec) -> list:
    """The steps that stand, by step count: a step a restore rewound is
    replaced by the one trained at its count later."""
    by_step = {s["step"]: s for s in rec["steps"]}
    return [by_step[k] for k in sorted(by_step)]


def recover_readings(res: dict, ref_losses) -> dict:
    """What a job's run shows: the survivors' losses against one process,
    the recovery's timeline from the kill, the commits, the steps/s."""
    alive = [r for r in res["recs"] if not r["detached"]]
    first = min(alive, key=lambda r: r["recoveries"][0]["rank"]
                if r["recoveries"] else 0)
    eff = _effective(first)
    gaps = [abs(s["loss"] - ref_losses[s["batch"]]) for s in eff]
    kill = [e["time"] for e in res["events"] if e["kind"] == "kill"]
    commits = [e for e in res["events"] if e["kind"] == "commit"]
    rcv = first["recoveries"][0] if first["recoveries"] else None
    timeline = None
    if rcv is not None and kill and res["exclusions"]:
        k = kill[0]
        timeline = {"kill_to_error_s": rcv["t_error"] - k,
                    "kill_to_exclusion_s": res["exclusions"][0]["time"] - k,
                    "kill_to_version_seen_s": rcv["t_version"] - k,
                    "kill_to_reformed_s": rcv["t_reformed"] - k,
                    "kill_to_restored_s": rcv["t_restored"] - k,
                    "kill_to_first_step_s": rcv["t_step"] - k}
    by_n = {}
    for s in first["steps"]:
        if s["step"] > 1 and not s["recovered"]:
            by_n.setdefault(s["n"], []).append(s["seconds"])
    warm = [c for c in commits if c["pair"][1] > 1]
    return {
        "sequence": [[s["n"], s["batch"]] for s in eff],
        "losses": [s["loss"] for s in eff], "loss_gaps": gaps,
        "max_loss_gap": max(gaps), "timeline": timeline,
        "recovery": rcv and {k: rcv[k] for k in (
            "cause", "from_version", "from_size", "version", "size",
            "restored", "rewound", "restore_bytes")},
        "restore_bytes": {r["rank"]: r["recoveries"][0]["restore_bytes"]
                          for r in alive if r["recoveries"]},
        "commit_dispatch_s": statistics.median(
            c["dispatch_s"] for c in warm) if warm else None,
        "commit_join_s": statistics.median(
            c["join_s"] for c in warm) if warm else None,
        "commit_bytes": warm[0]["nbytes"] if warm else None,
        "steps_per_s": {n: len(v) / sum(v) for n, v in by_n.items()},
        "step_seconds": by_n,
        "construct_s": {r["rank"]: r["construct_s"] for r in res["recs"]},
        "launches": {r["rank"]: r["launches"] for r in alive},
        "peak_memory_gb": {**{f"r{e['rank0']}_killed": e["peak_memory_gb"]
                              for e in res["events"] if e["kind"] == "kill"},
                           **{f"r{r['rank']}": r["peak_memory_gb"]
                              for r in res["recs"]}},
        "exits": res["exits"], "exclusions": res["exclusions"],
        "wall_s": res["wall_s"]}


def recover_gates(name: str, res: dict, read: dict) -> None:
    """Jobs A and B: one exclusion; the survivors at one (version, size);
    replicas and Adam moments bit for bit equal after the recovery and at
    the end; the restored pair one that a rank published; every step
    counted once; every step's loss within ELASTIC_LOSS_TOL of one
    process; K1-K4 at every layer of every microbatch."""
    job = RECOVER_JOBS[name]
    steps = job["steps"]
    alive = [r for r in res["recs"] if not r["detached"]]
    if len(res["exclusions"]) != 1:
        raise RuntimeError(f"{name}: exclusions {res['exclusions']}")
    if len(alive) != RECOVER_RANKS - 1 or {
            (r["version"], r["size"]) for r in alive} != {
            (res["server_version"], RECOVER_RANKS - 1)}:
        raise RuntimeError(f"{name}: survivors {[(r['rank'], r.get('version'), r.get('size')) for r in alive]}")
    bad = _elastic_bad_checks(alive)
    if bad or sorted(c["at"] for r in alive for c in r["checks"]) != [
            "end", "end", "recovery", "recovery"]:
        raise RuntimeError(f"{name}: replicas differ (rank, at, params, "
                           f"moments): {bad}")
    published = {tuple(e["pair"]) for e in res["events"]
                 if e["kind"] == "commit"}
    for r in alive:
        if [tuple(x["restored"]) for x in r["recoveries"]] != [
                (ELASTIC_ROWS * job["at"], job["at"])] or not {
                tuple(x["restored"]) for x in r["recoveries"]} <= published:
            raise RuntimeError(f"{name}: rank {r['rank']} restored "
                               f"{[x['restored'] for x in r['recoveries']]}"
                               f", published {sorted(published)}")
        if r["trained_samples"] != steps * ELASTIC_ROWS:
            raise RuntimeError(f"{name}: trained samples "
                               f"{r['trained_samples']}")
        need = ELASTIC_LAYERS * r["microbatches"]
        short = {k: v for k, v in r["launches"].items() if v < need}
        if short:
            raise RuntimeError(f"{name}: rank {r['rank']}: flash kernels "
                               f"launched {short}, needed {need}")
    want = [[RECOVER_RANKS if b < job["at"] else RECOVER_RANKS - 1, b]
            for b in range(steps)]
    if read["sequence"] != want:
        raise RuntimeError(f"{name}: steps {read['sequence']}, want {want}")
    if read["max_loss_gap"] > ELASTIC_LOSS_TOL:
        raise RuntimeError(f"{name}: losses apart from one process by "
                           f"{read['loss_gaps']} (limit {ELASTIC_LOSS_TOL})")


def phase_elastic_recover_470m(device, ref: dict) -> dict:
    """Failure recovery of the 470m GPT on the card (see
    :func:`elastic_recover_worker`): jobs A and B held to their gates and
    to one process over the same batches (``elastic_reference``'s run),
    then the planted fault C caught by the loss gate."""
    from concurrent.futures import ThreadPoolExecutor
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got = {"A": recover_job("A", tmp)}
        # C (the planted fault) runs beside B, for the budget: B's
        # timings carry C's load, A's are the phase's clean ones
        with ThreadPoolExecutor(2) as pool:
            jobs = {n: pool.submit(recover_job, n, tmp) for n in "BC"}
            got.update({n: f.result() for n, f in jobs.items()})
    wall = time.perf_counter() - t0
    out = {}
    for name, res in got.items():
        out[name] = read = recover_readings(res, ref["losses"])
        if name != "C":
            recover_gates(name, res, read)
    c = out["C"]
    c["loss_tol"] = ELASTIC_LOSS_TOL
    c["excess_over_limit"] = c["max_loss_gap"] - ELASTIC_LOSS_TOL
    if c["max_loss_gap"] <= ELASTIC_LOSS_TOL:
        raise RuntimeError(f"C: the stale restore was not caught: loss gaps "
                           f"{c['loss_gaps']} within {ELASTIC_LOSS_TOL}")
    return {"ranks": RECOVER_RANKS, "layers": ELASTIC_LAYERS,
            "steps": {k: j["steps"] for k, j in RECOVER_JOBS.items()},
            "backend": "gloo",
            "snapshot_every": 1, "loss_tol": ELASTIC_LOSS_TOL,
            "jobs": out, "reference_losses": ref["losses"],
            "wall_s": wall,
            "note": "C ran beside B; timeline in seconds of the wall clock "
                    "from the kill (the victim's note); restore_bytes 0: "
                    "the survivor restored its own pinned commit"}


def phase_elastic_nccl_reinit(device) -> dict:
    """NCCL at world 1 re-formed at versions 0, 1, 2, each at a fresh
    FileStore: an all-reduce and a tree broadcast at every version, the
    seconds of each (re)formation up to its first collective, and
    ``memory_reserved`` and the card's used memory after each (and the
    latter once before the first formation)."""
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed as D
    peers = ["127.0.0.1:31100"]
    tree = {"w": torch.randn(1024, 1024, device=device),
            "b": [torch.ones(4096, dtype=torch.bfloat16, device=device), 7],
            "step": torch.tensor(3.0)}
    flat = {k: v for k, v in (("w", tree["w"].clone()),
                              ("b", tree["b"][0].clone()))}
    seconds, reserved, used = [], [], []
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    used_before = total - free
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for v in range(ELASTIC_NCCL_VERSIONS):
                t0 = time.perf_counter()
                if v == 0:
                    D.initialize(peers, 0, v, tmp, "nccl")
                elif not D.reinit(peers, 0, v, tmp, "nccl"):
                    raise RuntimeError(f"no re-formation at version {v}")
                x = torch.full((1 << 20,), float(v + 1), device=device)
                dist.all_reduce(x)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                got = D.broadcast_tree(tree)
                torch.cuda.synchronize()
                if (D.version() != v or not bool((x == v + 1).all())
                        or not torch.equal(got["w"], flat["w"])
                        or not torch.equal(got["b"][0], flat["b"])
                        or got["b"][1] != 7 or float(got["step"]) != 3.0):
                    raise RuntimeError(f"version {v}: wrong values")
                del x, got
                reserved.append(torch.cuda.memory_reserved())
                free, total = torch.cuda.mem_get_info()
                used.append(total - free)
        finally:
            D.shutdown()
    growth = reserved[-1] - reserved[0]
    used_growth = used[-1] - used[0]
    for what, grew in (("memory_reserved", growth),
                       ("the card's used memory", used_growth)):
        if grew > ELASTIC_NCCL_MARGIN:
            raise RuntimeError(f"{what} grew {grew} bytes over "
                               f"{ELASTIC_NCCL_VERSIONS} versions (margin "
                               f"{ELASTIC_NCCL_MARGIN})")
    return {"versions": ELASTIC_NCCL_VERSIONS, "reinit_seconds": seconds,
            "memory_reserved": reserved, "reserved_growth": growth,
            "margin": ELASTIC_NCCL_MARGIN,
            "device_used_before_bytes": used_before,
            "device_used_bytes": used, "device_used_growth": used_growth}


# -------------------------- phase 14: sequence and tensor parallelism
# job -> ((dp, sp, tp), attention, layers).  A: the slice's path, the 470m
# at full width and depth over sp 2 x tp 2 on the flash kernels; B: dp
# and Ulysses' all-to-all (dense f32 scores [B, H/2, T, T] a layer: 4
# layers)
PAR_JOBS = {"A": ((1, 2, 2), "ring_flash", 24),
            "B": ((2, 2, 1), "ulysses", 4)}
PAR_SEQ = 4096                   # tokens a sequence (max_seq)
PAR_ROWS = 2                     # sequences a step
PAR_STEPS = ("sgd", "adamw", "adamw")
PAR_SGD_LR = 1e-2
# step 1's gradient, per tensor: ||rank's - one process's slice|| /
# ||one process's slice||.  bf16 compute: the ranks round partial
# products (tp) and merge the chunks' outputs in f32 (ring-flash), the
# one process rounds whole products, and the error grows with depth: a
# bf16 CPU rehearsal of job A at d_model 128 read 0.020, 0.036 and 0.051
# at 2, 12 and 24 layers (wq and wk the worst), its planted faults
# 0.85-1.92.  Set before the first run on the card (PERF.md §6)
PAR_GRAD_TOL = 0.15
PAR_LOSS_TOL = 2e-2              # |loss - one process's| at every step
# job -> the faults planted in its ranks, each read by the SGD step's
# gradient error against PAR_GRAD_TOL
PAR_FAULTS = {"A": ("no_future_mask", "tp_twice", "rope_no_offset"),
              "B": ("a2a_reversed",)}
PAR_TIMEOUT_S = 120.0            # a collective that never completes
PAR_BUDGET_S = 150.0


def par_config(layers: int):
    return G.GPTConfig(**dict(MODEL, n_layers=layers, max_seq=PAR_SEQ),
                       dtype=torch.bfloat16)


def par_batch(device):
    """The one global batch: row r holds PAR_SEQ + 1 seeded ids below
    2^(8 + 7r) (256 and the whole vocabulary)."""
    rng = np.random.RandomState(2026)
    rows = np.stack([rng.randint(0, 2 ** (8 + 7 * r), PAR_SEQ + 1)
                     for r in range(PAR_ROWS)])
    t = torch.from_numpy(rows).to(device)
    return t[:, :-1].contiguous(), t[:, 1:].contiguous()


def _named_leaves(tree, prefix=""):
    """(key, leaf) in ``tree_leaves`` order, keys like "layers/0/wq"."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _named_leaves(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def par_train(cfg, mesh, params, attn, steps=PAR_STEPS):
    """``steps`` on the one batch through ``threed.make_gpt_train_step``
    (bf16 compute over the f32 masters): SGD then AdamW.  Returns the
    losses, the seconds of each step (ending in a fetch of the loss) and
    the gradient the SGD step applied, as key -> tensor."""
    from kungfu_tpu_torch.parallel import threed as T3
    leaves = tree_leaves(params)
    tokens, targets = par_batch(leaves[0].device)
    grads = {}

    def capture(opt, args, kwargs):
        for (key, _), p in zip(_named_leaves(params), leaves):
            grads[key] = p.grad.detach().clone()

    sgd = torch.optim.SGD(leaves, lr=PAR_SGD_LR)
    sgd.register_step_pre_hook(capture)
    adamw = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-4)
    make = {k: T3.make_gpt_train_step(cfg, opt, mesh, params, attn=attn,
                                      compute_dtype=torch.bfloat16)
            for k, opt in (("sgd", sgd), ("adamw", adamw))}
    losses, seconds = [], []
    for kind in steps:
        t0 = time.perf_counter()
        losses.append(float(make[kind](tokens, targets)))
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, grads


def par_oracle(device, layers: int, path: str) -> dict:
    """One process, no group: the same model, weights, batch and
    optimizers with ``attn="flash"`` (K1-K4) at T = PAR_SEQ.  Writes the
    SGD step's gradient to ``path`` (bf16: the step rounds it to bf16
    once, so nothing is lost)."""
    from kungfu_tpu_torch.parallel import threed as T3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = par_config(layers)
    params = T3.init_gpt(cfg, None, seed=0, device=device)
    losses, seconds, grads = par_train(cfg, None, params, "flash")
    torch.save({k: g.to(torch.bfloat16).cpu() for k, g in grads.items()},
               path)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, grads
    torch.cuda.empty_cache()
    return {"losses": losses, "step_seconds": seconds,
            "peak_memory_gb": peak, "wall_s": time.perf_counter() - t0}


def _par_grad_errors(grads, ref, mesh, cfg) -> dict:
    """key -> ||g - ref slice|| / ||ref slice|| (this rank's tp slice of
    the one process's gradient)."""
    specs = dict(_named_leaves(G.param_specs(cfg)))
    tp, t = mesh.size("tp"), mesh.index("tp")
    out = {}
    for key, g in grads.items():
        want = ref[key]
        if specs[key] is not None and tp > 1:
            want = want.chunk(tp, dim=specs[key])[t]
        want = want.to(g.device).float()
        out[key] = ((g.float() - want).norm()
                    / want.norm().clamp(min=1e-30)).item()
    return out


def _par_worst(errs: dict, k: int = 3) -> list:
    return sorted(errs.items(), key=lambda kv: -kv[1])[:k]


class _CollectiveClock:
    """Wraps the port's collectives (``comm.collectives``: ``_reduce``
    under every all-reduce, ``ring_exchange`` under ``ppermute``,
    ``_all_to_all``; or the ``names`` given, such as ZeRO's
    ``_gather_tiled`` and ``_reduce_scatter_tiled``) to add up, per kind
    and group, the seconds between a synchronize before the call and one
    after it, the bytes a rank sends (its buffer) and the calls.  Without
    a mesh every group reads "fsdp"."""

    KINDS = {"_reduce": "all_reduce", "ring_exchange": "ppermute",
             "_all_to_all": "all_to_all", "_gather_tiled": "all_gather",
             "_reduce_scatter_tiled": "reduce_scatter"}

    def __init__(self, mesh, names=("_reduce", "ring_exchange",
                                    "_all_to_all")):
        from kungfu_tpu_torch.comm import collectives as C
        self.C, self.mesh, self.stats = C, mesh, {}
        self.saved = {n: getattr(C, n) for n in names}
        for name, fn in self.saved.items():
            setattr(C, name, self._wrap(name, fn))

    def _axes(self, group) -> str:
        if self.mesh is None:
            return "fsdp"
        for axes in (("tp",), ("sp",), ("dp",), ("dp", "sp")):
            if group is self.mesh.group(*axes):
                return ",".join(axes)
        return "other"

    def _wrap(self, name, fn):
        kind = self.KINDS[name]

        def run(x, group, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, group, *args, **kw)
            torch.cuda.synchronize()
            key = f"{kind}[{self._axes(group)}]"
            s = self.stats.setdefault(key, {"s": 0.0, "bytes": 0,
                                            "calls": 0})
            s["s"] += time.perf_counter() - t0
            s["bytes"] += sum(t.numel() * t.element_size()
                              for t in tree_leaves(x))
            s["calls"] += 1
            return out
        return run

    def take(self) -> dict:
        out, self.stats = self.stats, {}
        return out

    def close(self) -> None:
        for name, fn in self.saved.items():
            setattr(self.C, name, fn)


def _plant(fault: str, cfg):
    """Plant ``fault`` by monkeypatching the port; returns the undo."""
    import importlib
    import torch.distributed as dist
    from kungfu_tpu_torch.parallel import threed as T3
    RA = importlib.import_module("kungfu_tpu_torch.parallel.ring_attention")
    from kungfu_tpu_torch.comm import collectives as C
    saved = (RA._is_future, T3._sync_gradients, G._global_positions,
             C._all_to_all)
    if fault == "no_future_mask":          # merge the future chunk too
        RA._is_future = lambda src, rank: False
    elif fault == "tp_twice":              # replicated grads summed over tp
        orig = T3._sync_gradients
        specs = [d for _, d in _named_leaves(G.param_specs(cfg))]

        def sync(masters, mesh):
            orig(masters, mesh)
            for m, dim in zip(masters, specs):
                if dim is None:
                    dist.all_reduce(m.grad, group=mesh.group("tp"))
        T3._sync_gradients = sync
    elif fault == "rope_no_offset":        # every rank rotates by arange(T)
        G._global_positions = lambda T, g, dev: torch.arange(T, device=dev)
    elif fault == "a2a_reversed":          # blocks joined in reverse order
        orig_a2a = C._all_to_all

        def a2a(x, group, split_axis, concat_axis):
            y = orig_a2a(x, group, split_axis, concat_axis)
            n = dist.get_world_size(group)
            return torch.cat(y.chunk(n, concat_axis)[::-1], concat_axis)
        C._all_to_all = a2a
    else:
        raise ValueError(fault)

    def undo():
        (RA._is_future, T3._sync_gradients, G._global_positions,
         C._all_to_all) = saved
    return undo


def parallel_gpt_worker(rank: int, world: int, tmp: str) -> None:
    """A rank of a ``parallel_gpt_470m`` job (``tmp``/job.json): joins a
    gloo group through the FileStore in ``tmp``, forms the (dp, sp, tp)
    mesh, trains PAR_STEPS from the seeded weights with the collectives
    clocked, counts K1-K4 over those steps, holds the SGD step's gradient
    against the one process's (``tmp``/oracle.pt), and, for each planted
    fault the job names, starts again from the same weights, plants it,
    and reads the SGD step's gradient error.  Writes ``tmp``/r<rank>.json."""
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.parallel import threed as T3
    with open(os.path.join(tmp, "job.json")) as f:
        job = json.load(f)
    device = resolve_device("cuda")
    torch.set_num_threads(2)
    init_process_group_file(os.path.join(tmp, "store"), rank, world,
                            "gloo", timeout_s=PAR_TIMEOUT_S)
    mesh = T3.mesh_3d(*job["mesh"], timeout_s=PAR_TIMEOUT_S)
    cfg = par_config(job["layers"])
    ref = torch.load(os.path.join(tmp, "oracle.pt"), mmap=True,
                     weights_only=True)
    torch.cuda.reset_peak_memory_stats()
    params = T3.init_gpt(cfg, mesh, seed=0, device=device)
    clock = _CollectiveClock(mesh)
    _reset_flash_counts()                 # counts from the main path only
    try:
        losses, seconds, grads = par_train(cfg, mesh, params, job["attn"])
        counts = dict(FA.launches)
        collectives = clock.take()
    finally:
        clock.close()
    errs = _par_grad_errors(grads, ref, mesh, cfg)
    rec = {"rank": rank, "coords": list(mesh.coords), "losses": losses,
           "step_seconds": seconds, "launches": counts,
           "collectives": collectives, "grad_err_max": max(errs.values()),
           "grad_err_worst": _par_worst(errs),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "faults": {}}
    del params, grads
    for fault in job["faults"]:
        torch.cuda.empty_cache()
        undo = _plant(fault, cfg)
        try:
            params = T3.init_gpt(cfg, mesh, seed=0, device=device)
            f_losses, _, f_grads = par_train(cfg, mesh, params, job["attn"],
                                             steps=("sgd",))
        finally:
            undo()
        f_errs = _par_grad_errors(f_grads, ref, mesh, cfg)
        rec["faults"][fault] = {"grad_err_max": max(f_errs.values()),
                                "grad_err_worst": _par_worst(f_errs),
                                "loss": f_losses[0]}
        del params, f_grads
    with open(os.path.join(tmp, f"r{rank}.json"), "w") as f:
        json.dump(rec, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def par_launches_needed(attn: str, layers: int, coords) -> int:
    """K1-K4 launches each over PAR_STEPS on a rank: ring-flash runs the
    kernels on the diagonal chunk and on each past one (sp index + 1
    chunks a layer; the future ones are skipped); Ulysses runs none."""
    if attn != "ring_flash":
        return 0
    return layers * (coords[1] + 1) * len(PAR_STEPS)


def phase_parallel_gpt_470m(device, smi: str) -> dict:
    """The slice's path: the 470m GPT through
    ``parallel.threed.make_gpt_train_step`` in 4 gloo ranks sharing the
    card, PAR_JOBS A and B, each against one process (``par_oracle``).
    Gates: every rank's losses within PAR_LOSS_TOL of the one process's;
    every rank's gradient of the SGD step within PAR_GRAD_TOL of the one
    process's slice, tensor by tensor; in A, K1-K4 launched exactly
    ``par_launches_needed`` times; each planted fault's (PAR_FAULTS)
    gradient error above PAR_GRAD_TOL.  Reports the step seconds, the collectives' share
    of them and their bytes a step by kind, every rank's peak memory."""
    t_start = time.perf_counter()
    out, bad = {"card": smi}, []
    for name, (mesh, attn, layers) in PAR_JOBS.items():
        world = math.prod(mesh)
        faults = list(PAR_FAULTS[name])
        with tempfile.TemporaryDirectory() as tmp:
            ref = par_oracle(device, layers, os.path.join(tmp, "oracle.pt"))
            with open(os.path.join(tmp, "job.json"), "w") as f:
                json.dump({"mesh": mesh, "attn": attn, "layers": layers,
                           "faults": faults}, f)
            t0 = time.perf_counter()
            _spawn([_worker_argv("parallel_gpt_worker", r, world, tmp)
                    for r in range(world)], 600, tmp)
            job_s = time.perf_counter() - t0
            recs = []
            for r in range(world):
                with open(os.path.join(tmp, f"r{r}.json")) as f:
                    recs.append(json.load(f))
        steps = len(PAR_STEPS)
        gaps = [max(abs(a - b) for a, b in zip(r["losses"], ref["losses"]))
                for r in recs]
        need = [par_launches_needed(attn, layers, r["coords"])
                for r in recs]
        for r, gap, n in zip(recs, gaps, need):
            if not all(math.isfinite(x) for x in r["losses"]) \
                    or not gap <= PAR_LOSS_TOL:
                bad.append(f"{name} rank {r['rank']}: losses {r['losses']} "
                           f"vs {ref['losses']} (limit {PAR_LOSS_TOL})")
            if not r["grad_err_max"] <= PAR_GRAD_TOL:
                bad.append(f"{name} rank {r['rank']}: gradient "
                           f"{r['grad_err_worst']} above {PAR_GRAD_TOL}")
            if name == "A" and any(r["launches"][k] != n for k in FA.launches):
                bad.append(f"A rank {r['rank']}: launches {r['launches']}, "
                           f"the schedule issues {n} each")
        fault_reads = {f: max(r["faults"][f]["grad_err_max"] for r in recs)
                       for f in faults}
        for f, e in fault_reads.items():
            if not e > PAR_GRAD_TOL:
                bad.append(f"{name}: planted {f} reads {e}, not above "
                           f"{PAR_GRAD_TOL}")
        kinds = sorted({k for r in recs for k in r["collectives"]})
        out[name] = {
            "mesh": dict(zip(("dp", "sp", "tp"), mesh)), "attn": attn,
            "layers": layers, "tokens_a_step": PAR_ROWS * PAR_SEQ,
            "losses": recs[0]["losses"], "oracle_losses": ref["losses"],
            "loss_gap_max": max(gaps),
            "grad_err_max": [r["grad_err_max"] for r in recs],
            "grad_err_worst_rank0": recs[0]["grad_err_worst"],
            "launches": [r["launches"] for r in recs],
            "launches_needed": need,
            "step_seconds": [r["step_seconds"] for r in recs],
            "oracle_step_seconds": ref["step_seconds"],
            "collective_share": [
                sum(s["s"] for s in r["collectives"].values())
                / sum(r["step_seconds"]) for r in recs],
            "collective_bytes_a_step": {
                k: [r["collectives"].get(k, {"bytes": 0})["bytes"] / steps
                    for r in recs] for k in kinds},
            "collective_s_a_step": {
                k: [r["collectives"].get(k, {"s": 0.0})["s"] / steps
                    for r in recs] for k in kinds},
            "peak_memory_gb": [r["peak_memory_gb"] for r in recs],
            "oracle_peak_memory_gb": ref["peak_memory_gb"],
            "faults": {f: {"grad_err_max": e,
                           "worst": max((r["faults"][f] for r in recs),
                                        key=lambda x: x["grad_err_max"])
                           ["grad_err_worst"]}
                       for f, e in fault_reads.items()},
            "job_s": job_s, "oracle_s": ref["wall_s"]}
    out["tol"] = {"grad": PAR_GRAD_TOL, "loss": PAR_LOSS_TOL}
    out["seconds"] = time.perf_counter() - t_start
    out["budget_s"] = PAR_BUDGET_S
    if bad:
        raise RuntimeError("parallel_gpt_470m: " + "; ".join(bad))
    return out


# ------------------------------------ phase 15: sharded data parallelism
# job -> (step builder, layers, optimizer steps).  A: the slice's path,
# layerwise ZeRO-3 (remat) at full width and depth; B: ZeRO-1; C: flat
# ZeRO-3, whose monolithic gather's peak stands beside A's (its SGD step)
FSDP_JOBS = {"A": ("scan", 24, PAR_STEPS), "B": ("zero1", 24, PAR_STEPS),
             "C": ("flat", 24, PAR_STEPS[:1])}
FSDP_RANKS = 2
FSDP_SAVE_AT = 2                 # A saves its state after this step
FSDP_CE_CHUNK = 8192             # vocabulary chunk of the head's CE
# the SGD step's gradient, per tensor: ||rank's - one process's|| /
# ||one process's||, gathered and unravelled.  bf16 compute: each rank
# rounds its row's products, the one process both rows'; a bf16 CPU
# rehearsal of the phase at d_model 256 (4 heads, 1 KV head, d_ff 512, T
# 256, 24 layers) read 0.0168 in A, B and C (layers/0/wq the worst), its
# planted faults 1.005 and 1.022.  Set before the first run on the card
FSDP_GRAD_TOL = 0.08
# job -> the faults planted in its ranks: A's read by the SGD step's
# gradient error against FSDP_GRAD_TOL, B's by the replicas' bit check
FSDP_FAULTS = {"A": ("no_mean", "reversed"), "B": ("new_params",)}
FSDP_CLOCKED = ("_gather_tiled", "_reduce_scatter_tiled", "_reduce")
FSDP_BUDGET_S = 200.0


def fsdp_gpt_fns(cfg):
    """The GPT under ``make_fsdp_scan_step``'s contract: the embedding,
    one layer on the flash kernels (K1-K4), and the final norm with the
    chunked cross-entropy (the token mean)."""
    from kungfu_tpu_torch.ops.chunked_ce import chunked_cross_entropy

    def embed_fn(ep, batch):
        tokens = batch[0]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return G.embed(ep, tokens, pos[None], cfg)

    def layer_fn(lp, x):
        return G.apply_layer(lp, x, cfg, attn="flash")

    def head_loss_fn(hp, x, batch):
        return chunked_cross_entropy(G.rms_norm(x, hp["lnf"]), hp["lm_head"],
                                     batch[1], FSDP_CE_CHUNK).mean()
    return embed_fn, layer_fn, head_loss_fn


def fsdp_gpt_loss(cfg):
    """The same model as one ``loss_fn(params, batch)`` over the GPT's
    tree (B and C), each layer recomputed in the backward as in A."""
    embed_fn, layer_fn, head_loss_fn = fsdp_gpt_fns(cfg)

    def loss_fn(p, batch):
        x = embed_fn({"wte": p["wte"]}, batch)
        for layer in p["layers"]:
            x = torch.utils.checkpoint.checkpoint(layer_fn, layer, x,
                                                  use_reentrant=False)
        return head_loss_fn({"lnf": p["lnf"], "lm_head": p["lm_head"]}, x,
                            batch)
    return loss_fn


def fsdp_split(params):
    """The GPT's tree as the scan contract's pieces, layers stacked."""
    layers = {k: torch.stack([lay[k] for lay in params["layers"]])
              for k in params["layers"][0]}
    return {"embed": {"wte": params["wte"]}, "layers": layers,
            "head": {"lnf": params["lnf"], "lm_head": params["lm_head"]}}


def _fsdp_adamw(leaves):
    return torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)        # par_train's


def _fsdp_full(v, gather):
    """A [n * c] or [L, n * c] vector from this rank's [c] or [L, c]."""
    if v.dim() == 2:
        return gather(v.t().contiguous(), None).t()
    return gather(v.contiguous(), None)


def _fsdp_grad_errors(kind, grads, meta, ref) -> dict:
    """key -> ||g - ref|| / ||ref||, the SGD step's gradient against the
    one process's (``ref``, "layers/3/wq", ...), tensor by tensor: each
    rank sums over the part of every tensor in its chunks (``grads``: the
    step's gradient chunks by name), and one all-reduce adds the sums."""
    if kind == "scan":
        P = meta.pieces
        rows = [(grads["embed"], P["embed"], ""), (grads["head"], P["head"],
                                                   "")]
        rows += [(g, P["layers"], f"layers/{i}/")
                 for i, g in enumerate(grads["layers"])]
    else:
        rows = [(grads["flat"], meta.flat if kind == "zero1" else meta, "")]
    keys, sums = [], []
    for g, m, prefix in rows:
        lo, hi = m.r * m.local, (m.r + 1) * m.local
        off = 0
        for key, t in _named_leaves(m.unravel(torch.empty(
                m.n * m.local, device="meta")), prefix):
            a, b = max(off, lo), min(off + t.numel(), hi)
            off += t.numel()
            if a >= b:
                sums.append(torch.zeros(2, dtype=torch.float64))
            else:
                want = ref[key].reshape(-1)[a - (off - t.numel()):
                                            b - (off - t.numel())]
                want = want.to(g.device, torch.float32)
                got = g[a - lo:b - lo].float()
                sums.append(torch.stack([((got - want) ** 2).sum(),
                                         (want ** 2).sum()]).double().cpu())
            keys.append(key)
    total = torch.stack(sums)
    dist.all_reduce(total)
    return {k: math.sqrt(d) / max(math.sqrt(w), 1e-30)
            for k, (d, w) in zip(keys, total.tolist())}


def fsdp_plant(fault: str):
    """Plant ``fault`` by monkeypatching the port; returns the undo."""
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.parallel import fsdp as FS
    saved = (FS._mean, C._gather_tiled, FS._zero1_apply)
    if fault == "no_mean":               # the gradients summed, not meaned
        FS._mean = lambda grads, n: list(grads)
    elif fault == "reversed":            # rank 1 joins the blocks reversed
        orig = C._gather_tiled

        def gather(t, group):
            out = orig(t, group)
            if dist.get_rank(group) != 1:
                return out
            return torch.cat(out.chunk(dist.get_world_size(group))[::-1])
        C._gather_tiled = gather
    elif fault == "new_params":          # ZeRO-1 gathers the new chunks
        def apply(flat, shard, before, group):
            flat.copy_(C._gather_tiled(shard.detach(), group))
        FS._zero1_apply = apply
    else:
        raise ValueError(fault)

    def undo():
        FS._mean, C._gather_tiled, FS._zero1_apply = saved
    return undo


def fsdp_eval_loss(state, meta, fns, batch) -> float:
    """The loss at the scan step's parameters ``state`` (forward only, no
    update), meaned over the group as a step's is: each layer gathered in
    turn, as the step gathers it."""
    from kungfu_tpu_torch.parallel import fsdp as FS
    embed_fn, layer_fn, head_loss_fn = fns
    P = meta.pieces
    group = P["layers"].group

    def full(name, shard):
        return P[name].unravel(FS.fsdp_all_gather_params(shard, group))
    with torch.no_grad():
        batch = FS._local_rows(batch, group)
        x = embed_fn(full("embed", state["embed"]), batch)
        for layer_shard in state["layers"].unbind(0):
            x = layer_fn(full("layers", layer_shard), x)
        loss = head_loss_fn(full("head", state["head"]), x, batch)
        return float(FS._mean_loss(loss, group))


def fsdp_job(name, device, ref, tmp, rank, fault=None) -> dict:
    """Job ``name`` of FSDP_JOBS on this rank, from the seeded weights, on
    ``par_batch``: its losses, step seconds, peak GB a step, the SGD
    step's gradient error against the one process's (``ref``), and, on
    the counted run (no ``fault``), K1-K4 launches, the collectives by
    kind and the gathered bytes alive at once; B also bit-checks each
    step's replica against JAX's rule (its chunk equal to the chunk
    before plus the updates) and the replicas across ranks.  A saves its
    state after step FSDP_SAVE_AT (``tmp``/ck) and rank 0 keeps the
    gathered parameters and moments on the host (``snapshot``)."""
    from kungfu_tpu_torch.checkpoint import Checkpointer
    from kungfu_tpu_torch.parallel import fsdp as FS
    from kungfu_tpu_torch.parallel import threed as T3
    kind, layers, steps = FSDP_JOBS[name]
    if fault is not None:
        steps = steps[:1]
    cfg = par_config(layers)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = T3.init_gpt(cfg, None, seed=0, device=device)
    sgd_of = lambda ps: torch.optim.SGD(ps, lr=PAR_SGD_LR)
    if kind == "scan":
        init, make = FS.make_fsdp_scan_step(*fsdp_gpt_fns(cfg), sgd_of)
        params = fsdp_split(params)
    else:
        init, make = (FS.make_fsdp_step if kind == "flat"
                      else FS.make_zero1_step)(fsdp_gpt_loss(cfg), sgd_of)
    state, sgd, meta = init(params)
    del params
    torch.cuda.empty_cache()
    names = sorted(state) if kind == "scan" else ["flat"]
    leaves = ([meta.shard] if kind == "zero1" else tree_leaves(state))
    kept = tree_leaves(state) + ([meta.shard] if kind == "zero1" else [])
    rec = {"init_bytes": torch.cuda.memory_allocated() - base,
           "state_bytes": sum(t.numel() * t.element_size() for t in kept)}
    adamw = _fsdp_adamw(leaves)
    step = make(meta)
    grads, held, bits = {}, {}, []
    sgd.register_step_pre_hook(lambda o, a, k: grads.update(
        {n: p.grad.detach().clone() for n, p in zip(names, leaves)}))
    if kind == "zero1":
        m = meta.flat
        lo = m.r * m.local
        for o in (sgd, adamw):
            o.register_step_pre_hook(lambda o, a, k: held.update(
                before=meta.shard.detach().clone()))
            o.register_step_post_hook(lambda o, a, k: held.update(
                after=meta.shard.detach().clone()))
    from kungfu_tpu_torch.comm import collectives as C
    gather = C._gather_tiled
    batch = par_batch(device)
    undo = fsdp_plant(fault) if fault is not None else None
    clock = None if fault is not None else _CollectiveClock(None,
                                                            FSDP_CLOCKED)
    _reset_flash_counts()
    FS.reset_gathered()
    losses, seconds, peaks = [], [], []
    try:
        for i, opt_kind in enumerate(steps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses.append(float(step(state, sgd if opt_kind == "sgd"
                                     else adamw, batch)))
            seconds.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            if kind == "zero1":
                with torch.no_grad():
                    want = held["before"] + (held["after"] - held["before"])
                    bits.append(int((state[lo:lo + m.local] != want).sum()))
            if name == "A" and fault is None and i + 1 == FSDP_SAVE_AT:
                t0 = time.perf_counter()
                Checkpointer(os.path.join(tmp, "ck")).save(
                    i + 1, FS.fsdp_state_dict(state, adamw, meta),
                    meta={"step": i + 1})
                rec["save_s"] = time.perf_counter() - t0
                snap = {}
                for k, v in state.items():
                    size = meta.pieces[k].size
                    for e, t in (("params", v.detach()),
                                 ("exp_avg", adamw.state[v]["exp_avg"]),
                                 ("exp_avg_sq",
                                  adamw.state[v]["exp_avg_sq"])):
                        t = _fsdp_full(t, gather)[..., :size]
                        if rank == 0:
                            snap[f"{e}/{k}"] = t.cpu()
                rec["snapshot"] = snap if rank == 0 else None
    finally:
        if undo is not None:
            undo()
        if clock is not None:
            rec["collectives"] = clock.take()
            clock.close()
    rec.update(losses=losses, step_seconds=seconds, peak_memory_gb=peaks)
    if fault is None:
        rec["launches"] = dict(FA.launches)
        if kind == "scan":
            rec["loss_after"] = fsdp_eval_loss(state, meta, fsdp_gpt_fns(cfg),
                                               batch)
        rec["gathered_peak_bytes"] = FS.gathered["peak"]
        rec["gathered_calls"] = FS.gathered["calls"]
        pieces = (meta.pieces if kind == "scan" else
                  {"flat": meta.flat if kind == "zero1" else meta})
        rec["bytes_f32"] = {k: 4 * p.local * p.n for k, p in pieces.items()}
        rec["size"] = {k: p.size for k, p in pieces.items()}
    if grads:
        errs = _fsdp_grad_errors(kind, grads, meta, ref)
        rec["grad_err_max"] = max(errs.values())
        rec["grad_err_worst"] = _par_worst(errs)
    if kind == "zero1":
        rec["replica_bits_differ"] = bits
        sums = torch.stack([c.view(torch.int32).sum(dtype=torch.int64)
                            for c in state.chunk(64)]).cpu()
        got = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
        dist.all_gather(got, sums)
        rec["replicas_differ"] = [int((g != got[0]).sum()) for g in got]
    del state, sgd, adamw, grads, held
    torch.cuda.empty_cache()
    return rec


def fsdp_restore(device, tmp, snap, group) -> dict:
    """Rank 0 alone (``group``, a group of one): A's step-FSDP_SAVE_AT
    checkpoint restored into the n = 1 layout, held bit for bit to A's
    gathered parameters and moments (``snap``), then step 3 (AdamW): its
    loss, AdamW's step count after it, and the loss at the parameters it
    left (forward only)."""
    from kungfu_tpu_torch.checkpoint import Checkpointer
    from kungfu_tpu_torch.parallel import fsdp as FS
    from kungfu_tpu_torch.parallel import threed as T3
    cfg = par_config(FSDP_JOBS["A"][1])
    init, make = FS.make_fsdp_scan_step(
        *fsdp_gpt_fns(cfg), lambda ps: torch.optim.SGD(ps, lr=PAR_SGD_LR),
        group=group)
    state, _, meta = init(fsdp_split(T3.init_gpt(cfg, None, seed=0,
                                                 device=device)))
    adamw = _fsdp_adamw(tree_leaves(state))
    t0 = time.perf_counter()
    at, meta_json = FS.load_fsdp_state_dict(
        Checkpointer(os.path.join(tmp, "ck")), state, adamw, meta)
    restore_s = time.perf_counter() - t0
    differ = {}
    for k, v in state.items():
        got = {"params": v.detach()}
        got.update({e: adamw.state[v][e] for e in ("exp_avg", "exp_avg_sq")})
        for e, t in got.items():
            differ[f"{e}/{k}"] = int((t.cpu() != snap[f"{e}/{k}"]).sum())
    batch = par_batch(device)
    t0 = time.perf_counter()
    loss = float(make(meta)(state, adamw, batch))
    step3_s = time.perf_counter() - t0
    return {"step": at, "meta": meta_json, "restore_s": restore_s,
            "adam_step": [float(adamw.state[v]["step"])
                          for v in tree_leaves(state)],
            "bits_differ": differ, "step3_loss": loss,
            "step3_seconds": step3_s,
            "loss_after": fsdp_eval_loss(state, meta, fsdp_gpt_fns(cfg),
                                         batch)}


def fsdp_gpt_worker(rank: int, world: int, tmp: str) -> None:
    """A rank of ``fsdp_gpt_470m``: joins a gloo group through the
    FileStore in ``tmp``, runs jobs A, B and C with their planted faults
    after each, and on rank 0 the restore at n = 1.  Writes
    ``tmp``/r<rank>.json."""
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    device = resolve_device("cuda")
    torch.set_num_threads(2)
    init_process_group_file(os.path.join(tmp, "store"), rank, world,
                            "gloo", timeout_s=PAR_TIMEOUT_S)
    solo = dist.new_group([0])
    ref = torch.load(os.path.join(tmp, "oracle.pt"), mmap=True,
                     weights_only=True)
    rec = {"rank": rank}
    snap = None
    for name in FSDP_JOBS:
        rec[name] = fsdp_job(name, device, ref, tmp, rank)
        snap = rec[name].pop("snapshot", snap)
        rec[name]["faults"] = {
            f: fsdp_job(name, device, ref, tmp, rank, fault=f)
            for f in FSDP_FAULTS.get(name, ())}
    if rank == 0:
        rec["restore"] = fsdp_restore(device, tmp, snap, solo)
    dist.barrier()
    with open(os.path.join(tmp, f"r{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def fsdp_launches_needed(layers: int, steps: int) -> dict:
    """K1-K4 launches a rank of A makes: every layer of every step runs
    the flash forward twice (the step, then its recompute in the
    backward: remat) and the backward kernels once."""
    return {"fa_fwd": 2 * layers * steps, "fa_delta": layers * steps,
            "fa_bwd_dq": layers * steps, "fa_bwd_dkv": layers * steps}


def phase_fsdp_gpt_470m(device, smi: str) -> dict:
    """The slice's path: the 470m GPT under ``parallel.fsdp`` in 2 gloo
    ranks sharing the card (FSDP_JOBS A, B and C), against one process
    (``par_oracle``: flash attention, the same weights, rows and
    optimizers).  Gates: every rank's losses in A, B and C within
    PAR_LOSS_TOL of the one process's; the SGD step's gradient, tensor by
    tensor, within FSDP_GRAD_TOL; A's K1-K4 launches exactly
    ``fsdp_launches_needed``; A's gathered parameter bytes alive at once
    at most one layer, the embedding and the head; A's SGD step's peak
    below C's by at least the full f32 parameters less one layer; every
    job's device memory after ``init`` its state and less than half a
    layer more; A's checkpoint restored at n = 1 bit for bit, then its
    step 3: its loss and the loss at the parameters it leaves within
    PAR_LOSS_TOL of A's, AdamW's step count that of A's; each planted
    fault caught (A's above FSDP_GRAD_TOL, B's by the replicas' bit
    check, which B itself passes at every step).  Reports the step seconds, the collectives' seconds,
    share and bytes a step by kind, every job's peak GB a rank and the
    phase's own seconds.  Gloo's only routes are the port's:
    ``reduce_scatter_tensor`` and ``all_gather_into_tensor`` on CUDA
    tensors (``collectives._reduce_scatter_tiled``, ``_gather_tiled``)."""
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref = par_oracle(device, FSDP_JOBS["A"][1],
                         os.path.join(tmp, "oracle.pt"))
        t0 = time.perf_counter()
        _spawn([_worker_argv("fsdp_gpt_worker", r, FSDP_RANKS, tmp)
                for r in range(FSDP_RANKS)], 900, tmp)
        job_s = time.perf_counter() - t0
        recs = []
        for r in range(FSDP_RANKS):
            with open(os.path.join(tmp, f"r{r}.json")) as f:
                recs.append(json.load(f))
    out, bad = fsdp_readings(recs, ref)
    out.update(card=smi, job_s=job_s, seconds=time.perf_counter() - t_start,
               budget_s=FSDP_BUDGET_S)
    if bad:
        raise RuntimeError("fsdp_gpt_470m: " + "; ".join(bad))
    return out


def fsdp_readings(recs, ref):
    """``phase_fsdp_gpt_470m``'s record and its failed gates (a list of
    messages) from the ranks' records and the one process's run."""
    out, bad = {"ranks": FSDP_RANKS, "backend": "gloo"}, []
    out["oracle"] = {k: ref[k] for k in ("losses", "step_seconds",
                                         "peak_memory_gb", "wall_s")}
    for name, (kind, layers, steps) in FSDP_JOBS.items():
        jobs = [r[name] for r in recs]
        want = ref["losses"][:len(steps)]
        gaps = [max(abs(a - b) for a, b in zip(j["losses"], want))
                for j in jobs]
        for r, (j, gap) in enumerate(zip(jobs, gaps)):
            if not all(math.isfinite(x) for x in j["losses"]) \
                    or not gap <= PAR_LOSS_TOL:
                bad.append(f"{name} rank {r}: losses {j['losses']} vs "
                           f"{want} (limit {PAR_LOSS_TOL})")
            if not j["grad_err_max"] <= FSDP_GRAD_TOL:
                bad.append(f"{name} rank {r}: gradient "
                           f"{j['grad_err_worst']} above {FSDP_GRAD_TOL}")
        n_steps = len(steps)
        kinds = sorted({k for j in jobs for k in j["collectives"]})
        out[name] = {
            "kind": kind, "layers": layers, "steps": list(steps),
            "losses": jobs[0]["losses"], "loss_gap_max": max(gaps),
            "grad_err_max": [j["grad_err_max"] for j in jobs],
            "grad_err_worst_rank0": jobs[0]["grad_err_worst"],
            "launches": [j["launches"] for j in jobs],
            "step_seconds": [j["step_seconds"] for j in jobs],
            "collective_share": [
                sum(s["s"] for s in j["collectives"].values())
                / sum(j["step_seconds"]) for j in jobs],
            "collective_bytes_a_step": {
                k: [j["collectives"].get(k, {"bytes": 0})["bytes"] / n_steps
                    for j in jobs] for k in kinds},
            "collective_s_a_step": {
                k: [j["collectives"].get(k, {"s": 0.0})["s"] / n_steps
                    for j in jobs] for k in kinds},
            "peak_memory_gb": [j["peak_memory_gb"] for j in jobs],
            "gathered_peak_bytes": [j["gathered_peak_bytes"] for j in jobs],
            "gathered_calls": [j["gathered_calls"] for j in jobs],
            "bytes_f32": jobs[0]["bytes_f32"],
            "save_s": [j.get("save_s") for j in jobs],
            "faults": {f: {k: [j["faults"][f].get(k) for j in jobs]
                           for k in ("grad_err_max", "grad_err_worst",
                                     "losses", "replica_bits_differ")}
                       for f in FSDP_FAULTS.get(name, ())}}
        if kind == "zero1":
            out[name]["replica_bits_differ"] = [j["replica_bits_differ"]
                                                for j in jobs]
            out[name]["replicas_differ"] = jobs[0]["replicas_differ"]
            if any(any(j["replica_bits_differ"]) for j in jobs) \
                    or any(jobs[0]["replicas_differ"]):
                bad.append(f"B: replicas off JAX's rule "
                           f"{out[name]['replica_bits_differ']} or apart "
                           f"{jobs[0]['replicas_differ']}")
    a = out["A"]
    need = fsdp_launches_needed(FSDP_JOBS["A"][1], len(FSDP_JOBS["A"][2]))
    out["A"]["launches_needed"] = need
    for r, got in enumerate(a["launches"]):
        if got != need:
            bad.append(f"A rank {r}: launches {got}, the steps issue {need}")
    pieces = a["bytes_f32"]
    bound = pieces["layers"] + pieces["embed"] + pieces["head"]
    a["gathered_bound_bytes"] = bound
    if not max(a["gathered_peak_bytes"]) <= bound:
        bad.append(f"A: gathered bytes alive at once "
                   f"{a['gathered_peak_bytes']} above one layer, the "
                   f"embedding and the head ({bound})")
    full = out["C"]["bytes_f32"]["flat"]
    margin = (full - pieces["layers"]) / 1e9
    out["peak_gap_needed_gb"] = margin
    for r in range(FSDP_RANKS):
        pa, pc = a["peak_memory_gb"][r][0], out["C"]["peak_memory_gb"][r][0]
        if not pc - pa >= margin:
            bad.append(f"rank {r}: A's SGD step peak {pa} GB not below C's "
                       f"{pc} GB by {margin} GB")
    for f in FSDP_FAULTS["A"]:
        e = max(a["faults"][f]["grad_err_max"])
        if not e > FSDP_GRAD_TOL:
            bad.append(f"A: planted {f} reads {e}, not above "
                       f"{FSDP_GRAD_TOL}")
    for f in FSDP_FAULTS["B"]:
        got = out["B"]["faults"][f]["replica_bits_differ"]
        if not any(any(x) for x in got):
            bad.append(f"B: planted {f} passes the replicas' bit check {got}")
    slack = pieces["layers"] // 2
    out["init_slack_bytes"] = slack
    for name in FSDP_JOBS:
        out[name]["init_bytes"] = [(r[name]["init_bytes"],
                                    r[name]["state_bytes"]) for r in recs]
        for r, (got, held) in enumerate(out[name]["init_bytes"]):
            if not got <= held + slack:
                bad.append(f"{name} rank {r}: {got} B on the card after "
                           f"init, above its state's {held} B by more than "
                           f"{slack}")
    res = recs[0]["restore"]
    res["step3_loss_gap"] = abs(res["step3_loss"] - a["losses"][2])
    a["loss_after"] = [r["A"]["loss_after"] for r in recs]
    res["loss_after_gap"] = abs(res["loss_after"] - a["loss_after"][0])
    adam_steps = PAR_STEPS[:FSDP_SAVE_AT + 1].count("adamw")
    res["adam_step_needed"] = adam_steps
    out["restore"] = res
    if any(res["bits_differ"].values()) or res["step"] != FSDP_SAVE_AT:
        bad.append(f"restore: step {res['step']}, bits differ "
                   f"{res['bits_differ']}")
    if any(x != adam_steps for x in res["adam_step"]):
        bad.append(f"restore: AdamW's step after step 3 "
                   f"{res['adam_step']}, not {adam_steps}")
    if not res["step3_loss_gap"] <= PAR_LOSS_TOL:
        bad.append(f"restore: step 3 loss {res['step3_loss']} vs A's "
                   f"{a['losses'][2]}")
    if not res["loss_after_gap"] <= PAR_LOSS_TOL:
        bad.append(f"restore: loss after step 3 {res['loss_after']} vs "
                   f"A's {a['loss_after']}")
    out["tol"] = {"grad": FSDP_GRAD_TOL, "loss": PAR_LOSS_TOL}
    return out, bad


# the kernels' entry points in a ptxas report (nvcc names a source's
# anonymous namespace after the file, "paged_attention_cu_<hash>")
KERNEL_NAMES = r"(?:fa|paged_attention)_(?!cu_)\w+"
# the bf16 instantiations of the redesigned kernels, by mangled name: K1
# and K6 (fa_fwd<D, ...>, fa_nosoftmax<D, ...>; not fa_fwd_f32), K2
# (fa_delta<bf16, D>) and K5 (paged_attention_cluster<bf16, ...>)
BF16_KERNELS = (r"fa_(?:fwd|nosoftmax)ILi|fa_deltaI13__nv_bfloat16"
                r"|paged_attention_\w*I13__nv_bfloat16")


def bf16_spills(ptxas) -> list:
    """The ptxas lines (FV.ptxas_lines: "<kernel>: <line>") in which a bf16
    K1, K6, K2 or K5 instantiation reports a spill."""
    return [ln for ln in ptxas if re.match(BF16_KERNELS, ln)
            and re.search(r"[1-9]\d* bytes spill", ln)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    start = t0 = time.perf_counter()
    built = _build.build()
    ptxas = [ln for name in _build.SIGNATURES
             for ln in FV.ptxas_lines(_build.library_path(name).with_name(
                 _build.library_path(name).name + ".log").read_text(),
                 KERNEL_NAMES)]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built, "ptxas": ptxas})
    spills = bf16_spills(ptxas)
    if spills:
        raise RuntimeError(f"a bf16 K1, K6, K2 or K5 spills: {spills}")
    smi = BG.device_name(device)
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if sys.argv[1:] == ["--commit-cost"]:
        emit({"phase": "elastic_commit_cost",
              **phase_elastic_commit_cost(device)})
        return 0
    if sys.argv[1:] == ["--parallel"]:
        phase_flash_check(device, PAR_FLASH_CASES)
        emit({"phase": "parallel_gpt_470m",
              **phase_parallel_gpt_470m(device, smi)})
        return 0
    if sys.argv[1:] == ["--fsdp"]:
        phase_flash_check(device, PAR_FLASH_CASES)
        emit({"phase": "fsdp_gpt_470m", **phase_fsdp_gpt_470m(device, smi)})
        return 0
    if sys.argv[1:] == ["--serving-tp"]:
        phase_k5_tp2(device)
        cfg = G.GPTConfig(**MODEL, dtype=torch.bfloat16)
        params = G.init_params(
            torch.Generator(device=device).manual_seed(0), cfg)
        serve = phase_serve(params, cfg, device)
        emit({"phase": "serve_470m", **{k: v for k, v in serve.items()
                                        if k != "tokens"}})
        emit({"phase": "serve_470m_tp2",
              **phase_serve_470m_tp2(params, cfg, device, serve)})
        del params
        emit({"phase": "tp2_f32_2l", **phase_tp2_f32(device)})
        return 0

    k5_errs = phase_kernel(device)
    emit({"phase": "k5_faults", **phase_k5_faults(device)})
    k5 = phase_k5_time(device)["a_bf16_q1"]
    k5_tp2 = phase_k5_tp2(device)

    cfg = G.GPTConfig(**MODEL, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = G.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)
    n_params = sum(t.numel() for t in params.values()
                   if isinstance(t, torch.Tensor)) + sum(
        t.numel() for layer in params["layers"] for t in layer.values())
    emit({"phase": "init_470m", "seconds": time.perf_counter() - t0,
          "params": n_params})
    serve = phase_serve(params, cfg, device)
    emit({"phase": "serve_470m", **{k: v for k, v in serve.items()
                                    if k != "tokens"}})
    emit({"phase": "profile_470m", **phase_profile(params, cfg, device)})
    emit({"phase": "serve_470m_int8w", **phase_serve_int8w(
        params, cfg, device, serve["weight_bytes"])})
    emit({"phase": "profile_470m_int8w", **phase_profile(
        params, cfg, device, weights_int8=True)})
    emit({"phase": "serve_470m_prefix",
          **phase_serve_prefix(params, cfg, device)})
    torch.cuda.empty_cache()
    serve_tp2 = phase_serve_470m_tp2(params, cfg, device, serve)
    emit({"phase": "serve_470m_tp2", **serve_tp2})
    del params
    small = G.GPTConfig(**dict(MODEL, n_layers=4), dtype=torch.bfloat16)
    params = G.init_params(torch.Generator(device=device).manual_seed(1),
                           small)
    emit({"phase": "variant_4l", **phase_variant(
        params, small, device, "speculative3", speculative=3)})
    emit({"phase": "variant_4l", **phase_variant(
        params, small, device, "kv_int8", kv_dtype=torch.int8)})
    emit({"phase": "variant_4l", **phase_variant(
        params, small, device, "int8w_kvint8_spec3", weights_int8=True,
        kv_dtype=torch.int8, speculative=3)})
    del params
    emit({"phase": "fused_vs_gather_f32_2l",
          **phase_fused_vs_gather(device)})
    emit({"phase": "prefix_f32_2l", **phase_prefix_f32(device)})
    emit({"phase": "tp2_f32_2l", **phase_tp2_f32(device)})

    phase_flash_check(device)
    emit({"phase": "flash_faults", **phase_flash_faults(device)})
    flash = phase_flash_time(device)
    train = phase_train(device)
    emit({"phase": "train_470m", **train})
    emit({"phase": "train_profile_470m", **phase_train_profile(device)})
    emit({"phase": "train_flash_vs_dense_f32_2l",
          **phase_train_flash_vs_dense_f32_2l(device)})

    k6 = phase_k6_time(device, phase_nosoftmax_check(device))
    roof = phase_roofline(device, smi, k6)
    emit({"phase": "roofline", **roof})
    emit({"phase": "train_470m_hd128", **phase_train(device, "470m-hd128")})
    emit({"phase": "train_profile_470m_hd128",
          **phase_train_profile(device, "470m-hd128")})

    emit({"phase": "resnet_check", **phase_resnet_check(device)})
    emit({"phase": "train_resnet50", **phase_train_resnet50(device)})
    emit({"phase": "train_resnet50_profile",
          **phase_train_resnet50_profile(device)})
    emit({"phase": "prefetch", **phase_prefetch(device)})
    emit({"phase": "bert_base", **phase_bert_base(device)})
    emit({"phase": "optimizers_card_vs_cpu",
          **phase_optimizers_card_vs_cpu(device)})
    emit({"phase": "optimizers_bert_base_w1",
          **phase_optimizers_bert_base_w1(device)})
    emit({"phase": "optimizers_bert_base_2r",
          **phase_optimizers_bert_base_2r(device)})
    emit({"phase": "convergence_bert", **phase_convergence_bert(device)})
    emit({"phase": "elastic_nccl_reinit",
          **phase_elastic_nccl_reinit(device)})
    torch.cuda.empty_cache()
    ref = elastic_reference(device)
    emit({"phase": "elastic_gpt_470m",
          **phase_elastic_gpt_470m(device, ref)})
    emit({"phase": "elastic_recover_470m",
          **phase_elastic_recover_470m(device, ref)})
    torch.cuda.empty_cache()
    emit({"phase": "parallel_gpt_470m",
          **phase_parallel_gpt_470m(device, smi)})
    torch.cuda.empty_cache()
    emit({"phase": "fsdp_gpt_470m", **phase_fsdp_gpt_470m(device, smi)})
    emit({"phase": "wall", "seconds": time.perf_counter() - start})

    print(BG.device_name(device), flush=True)
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "kungfu_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "kungfu_tpu/ops/paged_attention.py:65",
        "launches": serve["k5_launches"],
        "max_abs_err": k5_errs["a_bf16_q1"], "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"],
        # the tp-2 shard's row a, and its launches on each rank of
        # serve_470m_tp2
        "tp2": dict({k: k5_tp2["tp2_bf16_q1"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}, launches=[r["k5_launches"]
                                      for r in serve_tp2["ranks"]])}]
    for name, line in FLASH_REPLACES.items():
        rec = flash["470m"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "kungfu_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"kungfu_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][name],
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    rec = k6["a_d64_full"]                 # the roofline's first K6 row
    kernels.append({
        "name": "fa_nosoftmax", "route": "cuda",
        "source": "kungfu_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "kungfu_tpu/benchmarks/roofline.py:123",
        "launches": roof["k6_launches"],
        **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
