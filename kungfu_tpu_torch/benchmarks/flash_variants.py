"""Build variants of the flash kernels side by side and check and time
each on the card: the backward (K3 ``fa_bwd_dq``, K4 ``fa_bwd_dkv``), or
with ``--fwd`` the forward (K1 ``fa_fwd``) and its tile loop without the
softmax (K6 ``fa_nosoftmax``).

    python -m kungfu_tpu_torch.benchmarks.flash_variants VARIANTS.json \\
        [--rounds 2] [--cases j_bf16_470m_train] [--sdpa] [--fwd]

Run it from the root of the repository: it holds the kernels to
``chip_smoke.py``'s cases, error measure and limits.  VARIANTS.json maps
a name to one of

* ``{"file": "path/to/flash_attention.cu"}``: another source with the same
  C interface (for instance the parent commit's, from ``git show``);
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
versions, and their times (with ``--sdpa`` also SDPA's forward).  Rounds
alternate the order of the variants (a, b, b, a).  One JSON line per
(variant, shape, round); exits non-zero if any check fails.
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


def variant_source(src: str, variant: dict) -> str:
    """``src`` with the variant's BwdCfg fields and substitutions."""
    if "file" in variant:
        return Path(variant["file"]).read_text()
    out = src
    for d in ("64", "128"):
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


def bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in _build.SIGNATURES[
            "flash_attention"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


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
                   fwd: bool = False) -> int:
    """One variant, in this process: returns the number of failures."""
    import chip_smoke as CS
    device = torch.device("cuda")
    _build._libs["flash_attention"] = bind(lib_path)
    fails = 0
    for case in cases:
        errs = CS.flash_case(device, case)
        over = CS.flash_over(errs, CS.FLASH_CASES[case][7])
        fails += bool(over)
        print(json.dumps({"variant": name, "case": case, "over": over}),
              flush=True)
    timer = Timer(device)
    if fwd:
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
    ap.add_argument("--fwd", action="store_true",
                    help="K1 and K6 in place of K3 and K4")
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cases = [c for c in args.cases.split(",") if c]
    if args.worker:
        return 1 if check_and_time(*args.worker, cases, args.sdpa,
                                   args.fwd) else 0
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = json.loads(Path(args.variants).read_text())
    with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
        return build_and_run(variants, Path(tmp), args)


def build_and_run(variants: dict, tmp: Path, args) -> int:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    t0 = time.perf_counter()
    procs = {}
    for name, variant in variants.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(variant_source(src, variant))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    _build.build(["flash_attention"])
    default = _build.library_path("flash_attention")
    kernels = FWD_KERNELS if args.fwd else BWD_KERNELS
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
            cmd += ["--sdpa"] * args.sdpa + ["--fwd"] * args.fwd
            rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
