#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kungfu_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. builds every CUDA kernel of the port from this checkout (nvcc, into
   kungfu_tpu_torch/_build/) and prints the card's name and power limit;
2. holds the paged-decode kernel (K5) against its plain PyTorch version on
   the card at the 470m serving shapes -- bf16, f32, multi-query, int8
   pool, poisoned scratch block -- and times it beside its bound, the
   plain version and one PyTorch attention call;
3. serves the repo's 470m GPT (kungfu_tpu/benchmarks/gpt.py preset,
   seed-initialized, bf16) over HTTP through the port's ServingServer:
   16 concurrent streamed requests, checking that every decode layer-step
   went through the kernel; profiles steady-state decode chunks
   (torch.profiler: device busy share, launches, top kernels); then a
   speculative (K=3) and an int8-KV engine at 4 layers;
4. checks that greedy tokens of an f32 full-width engine are the same
   with the fused kernel and with the gather path.

Each phase prints a JSON line.  The last two lines are the kernels record
and ``{"ok": true, "device": {...}}``.  Any failure exits non-zero; so
does a machine without a CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from kungfu_tpu_torch.models import gpt as G
from kungfu_tpu_torch.ops import _build
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


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing
class _Timer:
    """Median of per-run CUDA-event times (ms) after warm-up, with the
    L2 cache flushed before each run: in a decode step the other layers'
    weights pass through L2 between two calls of one layer's attend.  A
    spin kernel keeps the card busy while the host enqueues the run, so
    the events time the device work and not the host's launch overhead."""

    def __init__(self, device):
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, warmup: int = 3, runs: int = 25) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(runs):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


# --------------------------------------------------------- phase 2: K5
def k5_inputs(device, dtype, Q, quant, rng, S=8, H=16, KVH=4, Dh=64,
              bs=32, MB=32, N=512):
    """Ragged slots (positions 0 and 1023 included) with distinct blocks,
    zeros (scratch) beyond each slot's reach -- the engine's invariant."""
    pos = rng.randint(1, MB * bs - 1, S).astype(np.int32)
    pos[0], pos[1] = 0, MB * bs - 1
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


def phase_kernel(device) -> dict:
    rng = np.random.RandomState(0)
    cases = {"a_bf16_q1": (torch.bfloat16, 1, False, 2e-2),
             "b_f32_q1": (torch.float32, 1, False, 1e-5),
             "c_bf16_q4": (torch.bfloat16, 4, False, 2e-2),
             "d_int8_q1": (torch.bfloat16, 1, True, 2e-2)}
    errs = {}
    for name, (dtype, Q, quant, tol) in cases.items():
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
    torch.testing.assert_close(got.float(), clean.float(), rtol=2e-2,
                               atol=2e-2)
    emit({"phase": "k5_check", "case": "e_poisoned_scratch",
          "max_abs_err": err, "tol": 2e-2})
    # (a) timed at the main path's shapes
    inp = k5_inputs(device, torch.bfloat16, 1, False,
                    np.random.RandomState(1))
    timer = _Timer(device)
    rec = {"ms": timer(lambda: PA.paged_attention_queries(**inp)),
           "plain_ms": timer(lambda: PA.paged_attention_queries_ref(**inp)),
           "library_ms": timer(lambda: sdpa_yardstick(inp))}
    lib_err = (sdpa_yardstick(inp).float() - PA.paged_attention_queries_ref(
        **inp).float()).abs().max().item()
    rec.update(k5_bound(inp))
    rec["max_abs_err"] = errs["a_bf16_q1"]
    emit({"phase": "k5_time", "case": "a_bf16_q1", "library_err": lib_err,
          **rec, "gb_per_s": rec["bytes"] / rec["ms"] / 1e6})
    return rec


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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    kernels = {ev.key: ev.self_device_time_total
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}     # device rows only
    busy_us = sum(kernels.values())
    k5_us = sum(v for k, v in kernels.items() if "paged_attention" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"chunks": chunks, "chunk_steps": eng.K,
            "wall_ms_per_chunk": wall * 1e3 / chunks,
            "device_busy_ms_per_chunk": busy_us / 1e3 / chunks,
            "device_busy_share": busy_us / 1e6 / wall,
            "k5_ms_per_chunk": k5_us / 1e3 / chunks,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    t0 = time.perf_counter()
    built = _build.build()
    ptxas = [ln.strip() for name in _build.SIGNATURES
             for ln in _build.library_path(name).with_name(
                 _build.library_path(name).name + ".log").read_text()
             .splitlines() if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built, "ptxas": ptxas})
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    k5 = phase_kernel(device)

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

    print(nvidia_smi(), flush=True)
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "kungfu_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "kungfu_tpu/ops/paged_attention.py:65",
        "launches": serve["k5_launches"],
        "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
