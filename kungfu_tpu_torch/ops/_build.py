"""Build the port's CUDA sources (``ops/csrc/*.cu``) and bind them.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` -- seconds per build, where a
source that includes PyTorch's headers takes minutes.  Libraries land in
``kungfu_tpu_torch/_build/`` (git-ignored), named by a digest of the
source and the flags, so an edited source never loads a stale build.
Nothing is built at import: the first launch (or :func:`build`) does it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L3 = ctypes.POINTER(ctypes.c_longlong)     # (batch, time, head) strides
# source name -> {C function: (argtypes, restype)}.  Pointers and the
# stream are c_void_p so ctypes never cuts them to 32 bits; a launching
# function returns a CUDA error code (int, 0 = success).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "flash_attention": {
        # q, k, v, out, lse | qs, ks, vs | B, H, KVH, Tq, Tk, D, dtype,
        # causal | scale | stream
        "kft_flash_fwd": ([_P] * 5 + [_L3] * 3 + [_I] * 8 + [_F, _P], _I),
        # o, dout, dlse, delta | os, dos | B, H, T, D, dtype | stream
        "kft_flash_delta": ([_P] * 4 + [_L3] * 2 + [_I] * 5 + [_P], _I),
        # q, k, v, dout, lse, delta, dq | qs, ks, vs, dos | B, H, KVH, Tq,
        # Tk, D, dtype, causal | scale | stream
        "kft_flash_bwd_dq": ([_P] * 7 + [_L3] * 4 + [_I] * 8 + [_F, _P],
                             _I),
        # q, k, v, dout, lse, delta, dk, dv | qs, ks, vs, dos | ... as dq
        "kft_flash_bwd_dkv": ([_P] * 8 + [_L3] * 4 + [_I] * 8 + [_F, _P],
                              _I),
        # q, k, v, out | qs, ks, vs, os | B, H, T, D, causal | stream
        "kft_nosoftmax_fwd": ([_P] * 4 + [_L3] * 4 + [_I] * 5 + [_P], _I),
    },
    "paged_attention": {
        # q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, S, Q, H,
        # KVH, Dh, bs, MB, dtype, quant, scale, stream
        "kft_paged_attention": ([_P] * 8 + [_I] * 9 + [_F, _P], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (default: all) that has no current
    library, one ``nvcc`` per source, all started together.  Returns
    {name: seconds} for what was compiled; raises with the compiler's
    output if any build fails.  The ptxas report (registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)          # atomic: a reader never sees half
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
