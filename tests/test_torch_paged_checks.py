"""The K5 checks of chip_smoke.py on the CPU: what the card's run relies
on to see a wrong paged-decode kernel, at small sizes.

- The plain emulation of the kernel's split and merge (block b of a slot
  to part b % ranks, each part its own softmax state, merged with weights
  exp(m_r - max m)) reads within the K5 limit against the plain version;
  each planted fault (a merge that drops the part holding the newest
  keys, partials summed without their weights, a past-reach block read
  from scratch block 0) reads above it.
- k5_bound counts the bytes of the full-context row by hand.
- The build's spill check flags the bf16 K5 and K2 instantiations.
- The variant tool reads K5's ptxas lines and takes a paged source.
"""
import numpy as np
import pytest
import torch

import chip_smoke as CS
from kungfu_tpu_torch.benchmarks import flash_variants as FV
from kungfu_tpu_torch.ops import _build
from kungfu_tpu_torch.ops import paged_attention as PA

CPU = torch.device("cpu")
SMALL = dict(S=4, H=8, KVH=2, Dh=16, bs=8, MB=8, N=40)


def _small(dtype=torch.bfloat16, Q=1, quant=False, seed=3, **kw):
    return CS.k5_inputs(CPU, dtype, Q, quant, np.random.RandomState(seed),
                        **dict(SMALL, **kw))


@pytest.mark.parametrize("dtype,Q,quant,ranks", [
    (torch.bfloat16, 1, False, 4), (torch.bfloat16, 3, False, 2),
    (torch.bfloat16, 1, True, 4), (torch.float32, 1, False, 4),
    (torch.bfloat16, 1, False, 1)])
def test_split_emulation_without_fault_is_within_the_limit(dtype, Q, quant,
                                                           ranks):
    inp = _small(dtype, Q, quant)
    want = PA.paged_attention_queries_ref(**inp)
    got = CS._paged_split_plain(inp, ranks)
    tol = 1e-5 if dtype == torch.float32 else CS.K5_TOL
    assert got.shape == want.shape and got.dtype == want.dtype
    assert CS.k5_excess(got, want, tol) <= 1


@pytest.mark.parametrize("fault", CS.K5_FAULTS)
def test_planted_k5_faults_read_above_the_limit(fault):
    inp = _small()
    want = PA.paged_attention_queries_ref(**inp)
    got = CS._paged_split_plain(inp, 4, fault)
    assert CS.k5_excess(got, want, CS.K5_TOL) > 1


def test_k5_faults_phase_runs_on_the_cpu():
    """The phase's own inputs (the serve's a_bf16_q1 row) at full size:
    the sound split within the limit, every fault above it."""
    res = CS.phase_k5_faults(CPU)
    assert res["sound"] <= 1
    assert sorted(res["readings"]) == sorted(CS.K5_FAULTS)
    assert all(r > 1 for r in res["readings"].values())


def test_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        CS._paged_split_plain(_small(), 2, "no_such_fault")


def test_full_context_inputs_fill_every_table_entry():
    inp = _small(full=True)
    assert (inp["pos"] == SMALL["MB"] * SMALL["bs"] - 1).all()
    tables = inp["tables"]
    assert (tables > 0).all()
    assert len(set(tables.flatten().tolist())) == tables.numel()


def test_k5_bound_of_the_full_context_row_counts_bytes_by_hand():
    """Every slot at its last position: all MB blocks visited.  K and V:
    S * MB blocks of bs keys, KVH heads of Dh bf16 values each; q read
    and out written once; pos and the visited table entries, int32."""
    S, H, KVH, Dh, bs, MB = (SMALL[k] for k in ("S", "H", "KVH", "Dh",
                                                "bs", "MB"))
    rec = CS.k5_bound(_small(full=True))
    kv = 2 * S * MB * bs * KVH * Dh * 2
    io = 2 * S * 1 * H * Dh * 2 + S * 4 + S * MB * 4
    assert rec["bytes"] == kv + io
    assert rec["flops"] == 4 * S * MB * bs * 1 * H * Dh
    assert rec["bound_by"] == "bytes"
    assert rec["bound_ms"] == pytest.approx((kv + io) / CS.HBM_BYTES_PER_S
                                            * 1e3)


def test_k5_bound_of_the_serving_full_row_is_8_4_mb_of_kv():
    """At the serving shapes the full-context row reads 8 slots x 32
    blocks x 32 keys x 4 KV heads x 64 values x 2 bytes, for K and V."""
    inp = CS.k5_time_inputs(CPU, "f_bf16_q1_full")
    kv = 2 * 8 * 32 * 32 * 4 * 64 * 2
    assert kv == 8_388_608
    assert CS.k5_bound(inp)["bytes"] == kv + 2 * 8 * 16 * 64 * 2 + 8 * 4 \
        + 8 * 32 * 4


def test_k5_excess_is_the_assert_close_criterion():
    want = torch.tensor([1.0, -2.0, 0.0])
    tol = 0.1
    edge = want + tol * (1 + want.abs())
    assert CS.k5_excess(edge, want, tol) == pytest.approx(1.0)
    torch.testing.assert_close(want + 0.99 * (edge - want), want, rtol=tol,
                               atol=tol)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(want + 1.01 * (edge - want), want,
                                   rtol=tol, atol=tol)


def test_bf16_spills_flags_k5_and_k2_bf16_instantiations():
    spill = ": 16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"
    clean = ": 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    lines = [
        "paged_attention_clusterI13__nv_bfloat16S1_Lb0ELi64EEEvNS_6ParamsE"
        + spill,
        "paged_attention_clusterI13__nv_bfloat16aLb1ELi0EEEvNS_6ParamsE"
        + spill,
        "fa_deltaI13__nv_bfloat16Li128EEEvNS_6ParamsE" + spill,
        "paged_attention_clusterI13__nv_bfloat16S1_Lb0ELi128EEEvNS_6ParamsE"
        + clean,
        "paged_attention_clusterIffLb0ELi0EEEvNS_6ParamsE" + spill,
        "fa_deltaIfLi64EEEvNS_6ParamsE" + spill]
    assert CS.bf16_spills(lines) == lines[:3]


def test_variant_tool_reads_k5_ptxas_lines_and_paged_sources():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__"
        "7d2c0c6c_18_paged_attention_cu_310ce4f923paged_attention_clusterI13"
        "__nv_bfloat16S1_Lb0ELi64EEEvNS_6ParamsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_18fa_deltaI13__nv_bfloat16Li64EEEvNS_6ParamsE' "
        "for 'sm_90a'",
        "ptxas info    : Used 40 registers"])
    source, kernels = FV.MODES["paged"]
    assert source == "paged_attention"
    got = FV.ptxas_lines(log, kernels)
    assert [ln.split(":")[0] for ln in got] == [
        "paged_attention_clusterI13__nv_bfloat16S1_Lb0ELi64EEEvNS_6ParamsE"
    ] * 2
    assert [ln.split(":")[0] for ln in FV.ptxas_lines(
        log, FV.MODES["delta"][1])] == [
            "fa_deltaI13__nv_bfloat16Li64EEEvNS_6ParamsE"]
    assert [ln.split(":")[0] for ln in FV.ptxas_lines(
        log, CS.KERNEL_NAMES)] == [
            "paged_attention_clusterI13__nv_bfloat16S1_Lb0ELi64EEEvNS_6ParamsE",
            "paged_attention_clusterI13__nv_bfloat16S1_Lb0ELi64EEEvNS_6ParamsE",
            "fa_deltaI13__nv_bfloat16Li64EEEvNS_6ParamsE"]
    src = (_build.CSRC / "paged_attention.cu").read_text()
    out = FV.variant_source(src, {"sub": [["kWarps = 4;", "kWarps = 8;"]]})
    assert "kWarps = 8;" in out and out != src
