#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kungfu_tpu_torch) on one GPU.

    python3 chip_smoke.py

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
   and one PyTorch attention call;
3. serves the repo's 470m GPT (kungfu_tpu/benchmarks/gpt.py preset,
   seed-initialized, bf16) over HTTP through the port's ServingServer:
   16 concurrent streamed requests, checking that every decode layer-step
   went through the kernel; profiles steady-state decode chunks
   (torch.profiler: device busy share, launches, top kernels); then a
   speculative (K=3) and an int8-KV engine at 4 layers;
4. checks that greedy tokens of an f32 full-width engine are the same
   with the fused kernel and with the gather path;
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
   kernels record is that of phases 2-8.

Each phase prints a JSON line.  The last two lines are the kernels record
and ``{"ok": true, "device": {...}}``.  Any failure exits non-zero; so
does a machine without a CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import math
import os
import re
import statistics
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from kungfu_tpu_torch.benchmarks import flash_variants as FV
from kungfu_tpu_torch.benchmarks import gpt as BG
from kungfu_tpu_torch.benchmarks import resnet as BR
from kungfu_tpu_torch.benchmarks import roofline as RL
from kungfu_tpu_torch.benchmarks.timing import Timer
from kungfu_tpu_torch.comm.mesh import flat_mesh
from kungfu_tpu_torch.models import gpt as G
from kungfu_tpu_torch.ops import _build
from kungfu_tpu_torch.ops import flash_attention as FA
from kungfu_tpu_torch.ops import paged_attention as PA
from kungfu_tpu_torch.ops.flash_attention import _expand_kv_heads
from kungfu_tpu_torch.serving import DecodeEngine, Request, ServingServer
from kungfu_tpu_torch.serving.cache import quantize_kv
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


def emit(obj) -> None:
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
    """One PyTorch attention call on the gathered, GQA-expanded cache with
    the same mask (gather included) -- a yardstick the port never calls."""
    q, kp, vp, tables, pos = (inp["q"], inp["k_pool"], inp["v_pool"],
                              inp["tables"], inp["pos"])
    S, Q, H, Dh = q.shape
    idx = tables.long()
    kc = _expand_kv_heads(kp[idx].reshape(S, -1, kp.shape[2], Dh),
                          H // kp.shape[2])
    vc = _expand_kv_heads(vp[idx].reshape(S, -1, kp.shape[2], Dh),
                          H // kp.shape[2])
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


def phase_serve(params, cfg, device, n_req=16, max_new=64,
                plen=(8, 500)) -> dict:
    eng = DecodeEngine(params, cfg, device=device, **ENGINE)
    srv = ServingServer(eng, port=0).start()
    url = f"http://{srv.host}:{srv.port}/generate"
    try:
        _stream(url, [1, 2, 3], 2)                   # warm-up
        rng = np.random.RandomState(2)
        prompts = [rng.randint(0, cfg.vocab_size,
                               int(rng.randint(*plen))).tolist()
                   for _ in range(n_req)]
        results = [None] * n_req

        def client(i):
            results[i] = _stream(url, prompts[i], max_new)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_req)]
        eng.stats.reset()
        PA.launches = 0           # counts from the main path's run only
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = PA.launches
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        srv.close()
    for i, res in enumerate(results):
        if res is None:
            raise RuntimeError(f"request {i} got no reply")
        toks, _, tail = res
        if (len(toks) != max_new or not tail or not tail.get("done")
                or tail.get("tokens_total") != max_new):
            raise RuntimeError(f"request {i}: {len(toks)} tokens, {tail}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"request {i}: token out of range")
    need = cfg.n_layers * stats["dispatches"] * eng.K
    if launches < need or launches == 0:
        raise RuntimeError(f"K5 launched {launches} times, decode needed "
                           f"{need} ({cfg.n_layers} layers x "
                           f"{stats['dispatches']} dispatches x chunk "
                           f"{eng.K})")
    return {"requests": n_req, "max_new": max_new, "wall_s": wall,
            "tokens_per_s": n_req * max_new / wall,
            "mean_ttft_s": statistics.mean(r[1] for r in results),
            "k5_launches": launches, "k5_launches_needed": need,
            "stats": stats}


def phase_profile(params, cfg, device, chunks=4) -> dict:
    """Where a decode chunk's time goes: the 470m engine with all 8 slots
    decoding (prompts of 256), ``chunks`` steady-state chunks under
    torch.profiler.  Device busy share = summed kernel time / wall time
    (one stream, so kernels do not overlap); the rest is the card waiting
    on the host."""
    from torch.profiler import ProfilerActivity, profile
    eng = DecodeEngine(params, cfg, device=device, **ENGINE)
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
            "launches_per_chunk": sum(ev.count for ev in prof.key_averages()
                                      if ev.device_type == DeviceType.CUDA)
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
}
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


def phase_flash_check(device) -> dict:
    """Every case of FLASH_CASES within its limits."""
    errs = {}
    for name, case in FLASH_CASES.items():
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

    k5_errs = phase_kernel(device)
    emit({"phase": "k5_faults", **phase_k5_faults(device)})
    k5 = phase_k5_time(device)["a_bf16_q1"]

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
    emit({"phase": "serve_470m", **serve})
    emit({"phase": "profile_470m", **phase_profile(params, cfg, device)})
    del params
    small = G.GPTConfig(**dict(MODEL, n_layers=4), dtype=torch.bfloat16)
    params = G.init_params(torch.Generator(device=device).manual_seed(1),
                           small)
    emit({"phase": "variant_4l", **phase_variant(
        params, small, device, "speculative3", speculative=3)})
    emit({"phase": "variant_4l", **phase_variant(
        params, small, device, "kv_int8", kv_dtype=torch.int8)})
    del params
    emit({"phase": "fused_vs_gather_f32_2l",
          **phase_fused_vs_gather(device)})

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
    emit({"phase": "wall", "seconds": time.perf_counter() - start})

    print(BG.device_name(device), flush=True)
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "kungfu_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "kungfu_tpu/ops/paged_attention.py:65",
        "launches": serve["k5_launches"],
        "max_abs_err": k5_errs["a_bf16_q1"], "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"]}]
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
