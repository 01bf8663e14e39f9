"""The flash checks of chip_smoke.py on the CPU: what the card's run
relies on to see a wrong kernel, at small sizes.

- The planted forward faults (an accumulator that misses its rescale when
  a row's running max rises, in K1's plain tiled form and in the pipelined
  order of its wgmma loop) read above the per-tile limit, and the sound
  tiled forward reads below it.
- The K1 cases added for the wgmma tile loop run through the autograd
  function's CPU path (the kernels' plain versions) within FLASH_TOL.
- The build's spill check flags a bf16 K1 or K6 instantiation, not an f32
  one or K3/K4.
"""
import math

import pytest
import torch

import chip_smoke as CS
from kungfu_tpu_torch.benchmarks import flash_variants as FV

CPU = torch.device("cpu")


def _causal_inputs(B=1, T=512, H=4, KVH=2, D=64):
    q, k, v, do, _ = CS.flash_inputs(CPU, B, T, T, H, KVH, D, torch.bfloat16,
                                     seed=9)
    keep = torch.arange(T)[:, None] >= torch.arange(T)[None, :]
    return q, k, v, do, H // KVH, keep


def test_tiled_forward_without_fault_is_within_the_limit():
    q, k, v, do, g, keep = _causal_inputs()
    sound = CS._plain_chain(q, k, v, do, g, keep)[0]
    with torch.no_grad():
        got = CS._tiled_forward(q, k, v, g, keep)
    assert CS.flash_errors("out", got, sound)["tile"] <= \
        CS.flash_limits("out", "bf16")["tile"]


@pytest.mark.parametrize("fault", ["no_rescale", "pv_after_rescale"])
def test_planted_forward_faults_read_above_the_limit(fault):
    q, k, v, do, g, keep = _causal_inputs()
    sound = CS._plain_chain(q, k, v, do, g, keep)[0]
    with torch.no_grad():
        got = CS._tiled_forward(q, k, v, g, keep, fault)
    assert CS.flash_errors("out", got, sound)["tile"] > \
        CS.flash_limits("out", "bf16")["tile"]


def test_pv_after_rescale_differs_only_where_a_max_rises():
    """With one k-tile no row max rises after the first tile, so the
    pipelined-order fault changes nothing."""
    q, k, v, do, g, keep = _causal_inputs(T=CS.FLASH_TILE)
    with torch.no_grad():
        assert torch.equal(CS._tiled_forward(q, k, v, g, keep),
                           CS._tiled_forward(q, k, v, g, keep,
                                             "pv_after_rescale"))


@pytest.mark.parametrize("name", [
    "t_bf16_d128_g16_mqa_causal", "u_bf16_d64_causal_t130",
    "v_bf16_d128_causal_t130", "w_bf16_d64_causal_t257",
    "x_bf16_d128_causal_t257"])
def test_new_flash_cases_pass_on_the_cpu_path(name):
    """The wrappers take their plain versions on CPU tensors; the case's
    shapes (ragged last q-tile, MQA at D128) go through the same check
    as on the card."""
    B, Tq, Tk, H, KVH, D, causal, dt, _ = CS.FLASH_CASES[name]
    assert causal and dt == "bf16" and H % KVH == 0
    errs = CS.flash_case(CPU, name)
    assert CS.flash_over(errs, dt) == {}
    assert all(math.isfinite(e["max"]) for e in errs.values())


def test_fwd_spills_flags_bf16_forward_kernels_only():
    lines = [
        "fa_fwdILi64ELi2ELi2EEEvNS_6ParamsEf: 32 bytes stack frame, "
        "28 bytes spill stores, 28 bytes spill loads",
        "fa_nosoftmaxILi128ELi1ELi2EEEvNS_6ParamsE: 0 bytes stack frame, "
        "0 bytes spill stores, 0 bytes spill loads",
        "fa_fwd_f32ILi64EEEvNS_6ParamsEf: 8 bytes stack frame, 8 bytes "
        "spill stores, 8 bytes spill loads",
        "fa_bwd_dkvILi64ELi32ELi4EEEvNS_6ParamsEf: 16 bytes stack frame, "
        "16 bytes spill stores, 16 bytes spill loads"]
    assert CS.bf16_spills(lines) == lines[:1]
    assert CS.bf16_spills(lines[1:]) == []


def test_variant_tool_reads_forward_ptxas_lines():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_16fa_fwdILi64ELi2ELi2EEEvNS_6ParamsEf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 126 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_19fa_bwd_dqILi64EEEvNS_6ParamsEf' for 'sm_90a'",
        "ptxas info    : Used 145 registers, used 1 barriers"])
    got = FV.ptxas_lines(log, FV.FWD_KERNELS)
    assert [line.split(":")[0] for line in got] == [
        "fa_fwdILi64ELi2ELi2EEEvNS_6ParamsEf"] * 2
    assert [line.split(":")[0] for line in FV.ptxas_lines(log)] == [
        "fa_bwd_dqILi64EEEvNS_6ParamsEf"]
