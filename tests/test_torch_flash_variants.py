"""The flash backward variant tool (kungfu_tpu_torch/benchmarks/
flash_variants.py) on the CPU: how it writes a variant's source and reads
the ptxas report.  Building and timing need the card."""
import pytest
import torch

from kungfu_tpu_torch.benchmarks import flash_variants as FV
from kungfu_tpu_torch.ops import _build

SRC = (_build.CSRC / "flash_attention.cu").read_text()


def _cfg(src, d):
    a = src.index(f"struct BwdCfg<{d}> {{")
    return src[a:src.index("};", a)]


def test_variant_overrides_one_head_dim_and_leaves_the_other():
    out = FV.variant_source(SRC, {"64": {"kDkvQN": "64"}})
    assert "kDkvQN = 64" in _cfg(out, 64)
    assert _cfg(out, 128) == _cfg(SRC, 128)
    assert out.replace(_cfg(out, 64), "") == SRC.replace(_cfg(SRC, 64), "")


def test_variant_substitutes_text_and_reads_files(tmp_path):
    sub = [["fast_exp2(x - lse2", "exp2f(x - lse2"]]
    out = FV.variant_source(SRC, {"sub": sub})
    assert "exp2f(x - lse2" in out and out != SRC
    other = tmp_path / "other.cu"
    other.write_text("// another source\n")
    assert FV.variant_source(SRC, {"file": str(other)}) == "// another source\n"


@pytest.mark.parametrize("variant", [{"64": {"kNoSuchField": "1"}},
                                     {"sub": [["no such text", "x"]]}])
def test_variant_refuses_what_it_cannot_apply(variant):
    with pytest.raises(ValueError):
        FV.variant_source(SRC, variant)


def test_ptxas_lines_keep_k3_and_k4_only():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN1_fa_fwdILi64EE' for 'sm_90a'",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN1_fa_bwd_dkvILi64ELi32EE' for 'sm_90a'",
        "    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN1_fa_bwd_dqILi64ELi3EE' for 'sm_90a'",
        "ptxas info    : Used 149 registers, used 1 barriers"])
    got = FV.ptxas_lines(log)
    assert [line.split(":")[0] for line in got] == [
        "fa_bwd_dkvILi64ELi32EE", "fa_bwd_dkvILi64ELi32EE", "fa_bwd_dqILi64ELi3EE"]
    assert "spill stores" in got[0] and "149 registers" in got[2]


def test_without_a_card_the_tool_refuses(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "v.json"
    path.write_text("{}")
    assert FV.main([str(path)]) == 1
