"""Build variants of a kernel source side by side and check and time
each on the card: the flash backward (K3 ``fa_bwd_dq``, K4
``fa_bwd_dkv``); with ``--fwd`` the forward (K1 ``fa_fwd``) and its tile
loop without the softmax (K6 ``fa_nosoftmax``); with ``--delta`` the
backward's delta (K2 ``fa_delta``); with ``--paged`` the paged-decode
kernel (K5, ``paged_attention.cu`` in place of ``flash_attention.cu``).

    python -m kungfu_tpu_torch.benchmarks.flash_variants VARIANTS.json \\
        [--rounds 2] [--cases j_bf16_470m_train] [--sdpa] \\
        [--fwd | --delta | --paged]

Run it from the root of the repository: it holds the kernels to
``chip_smoke.py``'s cases, error measure and limits.  VARIANTS.json maps
a name to one of

* ``{"file": "path/to/flash_attention.cu"}``: another source with the same
  C interface (for instance the parent commit's, from ``git show``; with
  ``--paged``, a ``paged_attention.cu`` whose entry point takes the first
  K5's f32 workspace is run through that interface);
* ``{"64": {field: value}, "128": {...}, "sub": [[old, new], ...]}``: this
  checkout's source with fields of ``BwdCfg<64>`` / ``BwdCfg<128>``
  overridden and text substituted.

The checkout's own source runs as "default".  Every variant is compiled
by nvcc with the port's flags, all at once, and the ptxas lines of the
kernels timed (registers, spills) are printed.  Then each variant runs in
a process of its own, so a fault in one does not stop the others: the
named ``chip_smoke.FLASH_CASES`` through K1-K4, then at the 470m and the
470m-hd128 training shapes dq, dk and dv against their plain versions
(within ``chip_smoke.FLASH_TOL``), a bitwise repeat of K3 and K4, and
their times (``benchmarks.timing.Timer``; with ``--sdpa`` also SDPA's
backward).  With ``--fwd``: out and lse of K1 at the same two shapes and
K6 at the roofline's shapes (``chip_smoke.K6_ROWS``) against their plain
versions, and their times (with ``--sdpa`` also SDPA's forward).  With
``--delta``: K2 at the two shapes, with and without an lse cotangent,
against its plain version, a bitwise repeat, and its time beside
``torch.linalg.vecdot``'s.  With ``--paged``: ``chip_smoke.K5_CASES``
against the plain version, a bitwise repeat, and K5's time at each
``chip_smoke.K5_TIME_ROWS`` row (with ``--sdpa`` also SDPA after a
gather).  K2 and K5, read-bound, are also timed after a flush that leaves
L2 clean (``Timer``'s ``read_flush``).  Rounds alternate the order of the variants (a, b, b, a).  One
JSON line per (variant, shape, round); exits non-zero if any check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops import flash_attention as FA
from .timing import Timer

SHAPES = {"470m": {}, "470m_hd128": dict(H=8, KVH=2, D=128)}
BWD_KERNELS = r"fa_bwd_d(?:q|kv)\w*"
FWD_KERNELS = r"fa_(?:fwd|nosoftmax)\w*"
# mode -> (source in ops/csrc, kernels whose ptxas lines are printed)
MODES = {"bwd": ("flash_attention", BWD_KERNELS),
         "fwd": ("flash_attention", FWD_KERNELS),
         "delta": ("flash_attention", r"fa_delta\w*"),
         "paged": ("paged_attention", r"paged_attention_(?!cu_)\w+")}


def variant_source(src: str, variant: dict) -> str:
    """``src`` with the variant's BwdCfg fields and substitutions."""
    if "file" in variant:
        return Path(variant["file"]).read_text()
    out = src
    for d in ("64", "128"):
        if d not in variant:
            continue
        a = out.index(f"struct BwdCfg<{d}> {{")
        b = out.index("};", a)
        block = out[a:b]
        for field, val in variant.get(d, {}).items():
            block, n = re.subn(rf"\b{field} = [^,;]+", f"{field} = {val}",
                               block)
            if n != 1:
                raise ValueError(f"BwdCfg<{d}> has no field {field}")
        out = out[:a] + block + out[b:]
    for old, new in variant.get("sub", []):
        if old not in out:
            raise ValueError(f"substitution not found: {old[:60]!r}")
        out = out.replace(old, new)
    return out


def ptxas_lines(log: str, kernels: str = BWD_KERNELS) -> list:
    """The register and spill lines of the entry points whose names match
    ``kernels`` (default: K3 and K4)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(rf"entry function '.*?({kernels})'", line)
        if m:
            name = m.group(1)
        elif name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
            if "Used" in line:
                name = None
    return out


class _WorkspaceK5:
    """The first K5's entry point (a partial and a merge launch over an
    f32 workspace, which it sizes with ``kft_paged_attention_workspace``)
    behind the current one, so a parent's source can be timed beside the
    checkout's."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.kft_paged_attention_workspace.argtypes = [ctypes.c_int] * 6
        lib.kft_paged_attention_workspace.restype = ctypes.c_longlong
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.kft_paged_attention.argtypes = ([P] * 9 + [I] * 9
                                            + [ctypes.c_float, P])
        lib.kft_paged_attention.restype = I

    def kft_paged_attention(self, *args):
        S, Q, H, KVH, Dh, bs, MB = args[8:15]
        ws = torch.empty(self.lib.kft_paged_attention_workspace(
            S, Q, H, KVH, Dh, MB), dtype=torch.float32, device="cuda")
        return self.lib.kft_paged_attention(*args[:8], ws.data_ptr(),
                                            *args[8:])


def bind(path: str, source: str = "flash_attention"):
    lib = ctypes.CDLL(path)
    if source == "paged_attention" and hasattr(
            lib, "kft_paged_attention_workspace"):
        return _WorkspaceK5(lib)
    for fn, (argtypes, restype) in _build.SIGNATURES[source].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check_and_time_delta(name: str, device, timer) -> int:
    """K2 at SHAPES, with and without an lse cotangent, against its plain
    version (the f32 limits), twice for a bitwise repeat, and timed beside
    torch.linalg.vecdot: returns the number of failures."""
    import chip_smoke as CS
    fails = 0
    for tag, shape in SHAPES.items():
        s = dict(CS.FLASH_470M, **shape)
        B, Tq, Tk, H, KVH, D = (s[k] for k in ("B", "Tq", "Tk", "H", "KVH",
                                               "D"))
        q, k, v, do, dlse = CS.flash_inputs(device, B, Tq, Tk, H, KVH, D,
                                            s["dtype"], 7)
        out, _ = FA.flash_forward(q, k, v, True, H // KVH)
        vecdot = lambda: torch.linalg.vecdot(out, do, dim=-1)
        over, repeat = {}, True
        for lse_ct in (None, dlse):
            runs = [FA.flash_delta(out, do, lse_ct) for _ in range(2)]
            want = FA._delta_plain(out, do, lse_ct)
            errs = {"delta": CS.flash_errors("delta", runs[0], want)}
            if CS.flash_over(errs, "bf16"):
                over["delta" if lse_ct is None else "delta_dlse"] = errs
            repeat &= torch.equal(*runs)
        fails += bool(over) + (not repeat)
        print(json.dumps({
            "variant": name, "shape": tag, "kernel": "fa_delta",
            "over": over, "bitwise_repeat": repeat,
            "ms": timer(lambda: FA.flash_delta(out, do)),
            "read_flush_ms": timer(lambda: FA.flash_delta(out, do),
                                   read_flush=True),
            "vecdot_ms": timer(vecdot),
            "vecdot_read_flush_ms": timer(vecdot, read_flush=True)}),
              flush=True)
    return fails


def check_and_time_paged(name: str, device, timer, sdpa: bool) -> int:
    """K5 at chip_smoke.K5_CASES against its plain version, a bitwise
    repeat, and its time at each chip_smoke.K5_TIME_ROWS row: returns the
    number of failures."""
    import numpy as np
    import chip_smoke as CS
    from ..ops import paged_attention as PA
    fails = 0
    rng = np.random.RandomState(0)
    for case, (dtype, Q, quant, tol) in CS.K5_CASES.items():
        inp = CS.k5_inputs(device, dtype, Q, quant, rng)
        runs = [PA.paged_attention_queries(**inp) for _ in range(2)]
        excess = CS.k5_excess(runs[0],
                              PA.paged_attention_queries_ref(**inp), tol)
        repeat = torch.equal(*runs)
        fails += (not excess <= 1) + (not repeat)
        print(json.dumps({"variant": name, "case": case, "excess": excess,
                          "bitwise_repeat": repeat}), flush=True)
    for row in CS.K5_TIME_ROWS:
        inp = CS.k5_time_inputs(device, row)
        excess = CS.k5_excess(PA.paged_attention_queries(**inp),
                              PA.paged_attention_queries_ref(**inp),
                              CS.K5_TOL)
        fails += not excess <= 1
        rec = {"variant": name, "shape": row, "kernel": "paged_attention",
               "excess": excess,
               "ms": timer(lambda: PA.paged_attention_queries(**inp)),
               "read_flush_ms": timer(
                   lambda: PA.paged_attention_queries(**inp),
                   read_flush=True),
               "bound_ms": CS.k5_bound(inp)["bound_ms"]}
        if sdpa:
            rec["sdpa_ms"] = timer(lambda: CS.sdpa_yardstick(inp))
        print(json.dumps(rec), flush=True)
    return fails


def check_and_time_fwd(name: str, device, timer, sdpa: bool) -> int:
    """K1 at SHAPES and K6 at the roofline's shapes against their plain
    versions, and timed: returns the number of failures."""
    import chip_smoke as CS
    from . import roofline as RL
    fails = 0
    for tag, shape in SHAPES.items():
        s = dict(CS.FLASH_470M, **shape)
        B, Tq, Tk, H, KVH, D = (s[k] for k in ("B", "Tq", "Tk", "H", "KVH",
                                               "D"))
        g = H // KVH
        q, k, v, _, _ = CS.flash_inputs(device, B, Tq, Tk, H, KVH, D,
                                        s["dtype"], 7)
        fwd = lambda: FA.flash_forward(q, k, v, True, g)
        want = FA.flash_attention_ref(q, FA._expand_kv_heads(k, g),
                                      FA._expand_kv_heads(v, g), True)
        errs = {key: CS.flash_errors(key, got, w)
                for key, got, w in zip(("out", "lse"), fwd(), want)}
        over = CS.flash_over(errs, "bf16")
        fails += bool(over)
        rec = {"variant": name, "shape": tag, "kernel": "fa_fwd",
               "over": over, "ms": timer(fwd)}
        if sdpa:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            rec["sdpa_fwd_ms"] = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        print(json.dumps(rec), flush=True)
    for case in CS.K6_ROWS:
        causal = CS.NOSOFTMAX_CASES[case][4]
        errs, _, (q, k, v), _ = CS.nosoftmax_case(device, case)
        over = CS.flash_over({"out": errs}, "bf16")
        fails += bool(over)
        print(json.dumps({"variant": name, "shape": case,
                          "kernel": "fa_nosoftmax", "over": over,
                          "ms": timer(lambda: RL.nosoftmax_attention(
                              q, k, v, causal))}), flush=True)
    return fails


def check_and_time(name: str, lib_path: str, cases, sdpa: bool,
                   mode: str = "bwd") -> int:
    """One variant, in this process: returns the number of failures."""
    import chip_smoke as CS
    device = torch.device("cuda")
    source = MODES[mode][0]
    _build._libs[source] = bind(lib_path, source)
    timer = Timer(device)
    if mode == "paged":
        return check_and_time_paged(name, device, timer, sdpa)
    if mode == "delta":
        return check_and_time_delta(name, device, timer)
    fails = 0
    for case in cases:
        errs = CS.flash_case(device, case)
        over = CS.flash_over(errs, CS.FLASH_CASES[case][7])
        fails += bool(over)
        print(json.dumps({"variant": name, "case": case, "over": over}),
              flush=True)
    if mode == "fwd":
        return fails + check_and_time_fwd(name, device, timer, sdpa)
    for tag, shape in SHAPES.items():
        s = dict(CS.FLASH_470M, **shape)
        B, Tq, Tk, H, KVH, D = (s[k] for k in ("B", "Tq", "Tk", "H", "KVH",
                                               "D"))
        g = H // KVH
        q, k, v, do, _ = CS.flash_inputs(device, B, Tq, Tk, H, KVH, D,
                                         s["dtype"], 7)
        out, lse = FA.flash_forward(q, k, v, True, g)
        delta = FA.flash_delta(out, do)
        dq = lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, True, g)
        dkv = lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, True, g)
        runs = [(dq(), *dkv()) for _ in range(2)]
        want = (FA._dq_plain(q, k, v, do, lse, delta, True, g),
                *FA._dkv_plain(q, k, v, do, lse, delta, True, g))
        errs = {key: CS.flash_errors(key, got, w) for key, got, w in
                zip(("dq", "dk", "dv"), runs[0], want)}
        over = CS.flash_over(errs, "bf16")
        repeat = all(torch.equal(a, b) for a, b in zip(*runs))
        fails += bool(over) + (not repeat)
        rec = {"variant": name, "shape": tag, "over": over,
               "bitwise_repeat": repeat, "dq_ms": timer(dq),
               "dkv_ms": timer(dkv)}
        if sdpa:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
            rec["sdpa_bwd_ms"] = timer(lambda: torch.autograd.grad(
                o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        print(json.dumps(rec), flush=True)
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", help="JSON file: name -> variant")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cases", default="",
                    help="comma-separated chip_smoke.FLASH_CASES names")
    ap.add_argument("--sdpa", action="store_true")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fwd", action="store_const", dest="mode",
                      const="fwd", help="K1 and K6 in place of K3 and K4")
    mode.add_argument("--delta", action="store_const", dest="mode",
                      const="delta", help="K2 in place of K3 and K4")
    mode.add_argument("--paged", action="store_const", dest="mode",
                      const="paged",
                      help="K5 (paged_attention.cu) in place of K3 and K4")
    ap.set_defaults(mode="bwd")
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cases = [c for c in args.cases.split(",") if c]
    if args.worker:
        return 1 if check_and_time(*args.worker, cases, args.sdpa,
                                   args.mode) else 0
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = json.loads(Path(args.variants).read_text())
    with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
        return build_and_run(variants, Path(tmp), args)


def build_and_run(variants: dict, tmp: Path, args) -> int:
    source, kernels = MODES[args.mode]
    src = (_build.CSRC / f"{source}.cu").read_text()
    t0 = time.perf_counter()
    procs = {}
    for name, variant in variants.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(variant_source(src, variant))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    _build.build([source])
    default = _build.library_path(source)
    libs = {"default": str(default)}
    ptxas = {"default": ptxas_lines(
        default.with_name(default.name + ".log").read_text(), kernels)}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        libs[name] = str(tmp / f"{name}.so")
        ptxas[name] = ptxas_lines(log, kernels)
    print(json.dumps({"build_seconds": time.perf_counter() - t0,
                      "ptxas": ptxas}), flush=True)
    rc = 0
    order = list(libs.items())
    for rnd in range(args.rounds):
        for name, path in order if rnd % 2 == 0 else order[::-1]:
            cmd = [sys.executable, "-m", __spec__.name, args.variants,
                   "--cases", args.cases, "--worker", name, path]
            cmd += ["--sdpa"] * args.sdpa
            cmd += [f"--{args.mode}"] * (args.mode != "bwd")
            rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
