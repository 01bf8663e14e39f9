"""The port's kernel roofline against the JAX package's, on the CPU.

K6's plain version is held against the JAX ``_nosoftmax_kernel`` (Pallas
in interpret mode), called through ``bench_kernel_ceiling`` itself with
its timing loop replaced by one call that keeps the output.  Tolerance:
the largest norm-relative error of a 64-row tile is at most 2^-8, one
bf16 rounding.  Both sides sum the f32 products in their own order and
round s and the output to bf16, so a value near a rounding boundary may
land one bf16 step apart; anything larger is a different function.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.benchmarks import roofline as JR
from kungfu_tpu.monitor.profiler import load_ceilings
from kungfu_tpu_torch.benchmarks import roofline as RL
from kungfu_tpu_torch.benchmarks.timing import Timer

REPO = Path(__file__).resolve().parents[1]
TILE_TOL = 2.0 ** -8


def _tile_err(got, want, rows=64):
    """The largest ||got - want|| / ||want|| over tiles of ``rows`` along
    T of [B, H, T, D] outputs."""
    d, w = got.float() - want.float(), want.float()
    return max((dd.norm() / ww.norm()).item()
               for dd, ww in zip(d.split(rows, 2), w.split(rows, 2)))


def _jax_ceiling(monkeypatch, B, T, H, D, bq, bk, causal):
    """The JAX K6 output on the harness's own inputs."""
    kept = []

    def once(make_op, init, reps, iters=3):
        kept.append(np.array(make_op(init).astype(jnp.float32)))
        return 1.0

    monkeypatch.setattr(JR, "_time_chained", once)
    JR.bench_kernel_ceiling(B, T, H, D, reps=1, bq=bq, bk=bk, causal=causal)
    return torch.from_numpy(kept[0])


def _harness_inputs(B, T, H, D):
    """bench_kernel_ceiling's inputs redrawn: RandomState(0), q, then k,
    then v, [B, H, T, D] bf16."""
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.randn(B, H, T, D)).to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("bq,bk", [(64, 64), (256, 256), (64, 128)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_nosoftmax_plain_matches_jax_kernel(monkeypatch, D, causal, bq, bk):
    want = _jax_ceiling(monkeypatch, 1, 256, 2, D, bq, bk, causal)
    q, k, v = _harness_inputs(1, 256, 2, D)
    got = RL._nosoftmax_plain(q, k, v, causal, bq, bk)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _tile_err(got, want) <= TILE_TOL


def test_nosoftmax_wrapper_on_cpu_honours_blocks():
    """CPU tensors take the plain version at the blocks asked for, and
    no kernel launch is counted.  Under causal the blocks change the
    result (a straddling block is computed whole)."""
    q, k, v = _harness_inputs(1, 256, 2, 64)
    before = RL.launches["nosoftmax"]
    outs = {(bq, bk): RL.nosoftmax_attention(q, k, v, True, bq, bk)
            for bq, bk in ((64, 64), (64, 128), (256, 256))}
    assert RL.launches["nosoftmax"] == before
    for (bq, bk), out in outs.items():
        assert torch.equal(out, RL._nosoftmax_plain(q, k, v, True, bq, bk))
    assert not torch.equal(outs[64, 64], outs[64, 128])
    assert torch.equal(outs[256, 256],
                       RL.nosoftmax_attention(q, k, v, False, 64, 64))
    with pytest.raises(ValueError, match="one"):
        RL.nosoftmax_attention(q, k[:, :1], v, True)


@pytest.mark.parametrize("T,causal,bq,bk,pairs", [
    (2048, False, 64, 64, 1024), (2048, True, 64, 64, 528),
    (256, True, 64, 128, 6), (1000, True, 64, 64, 136)])
def test_visible_block_pairs_count_what_the_mask_keeps(T, causal, bq, bk,
                                                       pairs):
    """The block pairs the bounds count are those _block_keep reads."""
    assert RL._visible_block_pairs(T, causal, bq, bk) == pairs
    keep = RL._block_keep(T, causal, bq, bk, "cpu")
    n_q, n_k = -(-T // bq), -(-T // bk)
    pad = torch.zeros(n_q * bq, n_k * bk, dtype=torch.bool)
    pad[:T, :T] = keep
    blocks = pad.reshape(n_q, bq, n_k, bk).any(dim=3).any(dim=1)
    assert int(blocks.sum()) == pairs


def test_timer_on_cpu_times_reps_calls():
    calls = []
    ms = Timer("cpu")(lambda: calls.append(1), warmup=2, runs=3, reps=4)
    assert ms >= 0 and len(calls) == 2 + 3 * 4


def test_roofline_harness_writes_the_jax_schema(tmp_path):
    """``--tiny --device cpu`` writes the artifact the JAX harness's test
    checks, and kfprof's load_ceilings reads its ceilings."""
    out = tmp_path / "roofline.json"
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.benchmarks.roofline",
         "--tiny", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-800:]
    doc = json.loads(out.read_text())
    assert doc["platform"] == "cpu" and doc["device"] == "cpu"
    ops = {x["op"].split("_")[0] for x in doc["results"]}
    assert {"matmul", "flash", "kernel", "hbm", "library"} <= ops
    assert all(x["seconds"] > 0 and x["ms"] > 0 for x in doc["results"])
    ceiling = [x for x in doc["results"] if x["op"].startswith("kernel")]
    assert ceiling[0]["flops_done"] == 4.0 * 2 * 64 * 64 * 64 * 16
    c = load_ceilings(str(out))
    assert c is not None and c.matmul_flops > 0 and c.hbm_bytes_s > 0
