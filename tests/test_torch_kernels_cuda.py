"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode).  The file imports no JAX (nor does chip_smoke.py,
whose flash cases it shares), so it also runs on a GPU machine without
it, from the root of the repo:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from kungfu_tpu_torch.benchmarks import roofline as RL
from kungfu_tpu_torch.models import gpt as G
from kungfu_tpu_torch.ops import flash_attention as FA
from kungfu_tpu_torch.ops import paged_attention as PA
from kungfu_tpu_torch.serving import DecodeEngine, Request
from kungfu_tpu_torch.serving.cache import quantize_kv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, dtype, Q, quant, S=6, H=16, KVH=4, Dh=64, bs=32, MB=8,
            seed=5):
    """Ragged slots (one at position 0, one at the last) with distinct
    blocks and a poisoned scratch block 0 that no visible position maps
    to."""
    rng = np.random.RandomState(seed)
    N = S * MB + 1
    pos = rng.randint(0, MB * bs, S).astype(np.int32)
    pos[0], pos[1] = 0, MB * bs - 1      # one slot at the last position
    tables = np.zeros((S, MB), np.int32)
    free = list(range(1, N))
    rng.shuffle(free)
    for s in range(S):
        for b in range(min(MB, (pos[s] + Q - 1) // bs + 1)):
            tables[s, b] = free.pop()
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(device, dt)
    kf = t(rng.randn(N, bs, KVH, Dh).astype(np.float32))
    vf = t(rng.randn(N, bs, KVH, Dh).astype(np.float32))
    kf[0] = 1e3
    vf[0] = 1e3
    if quant:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(dtype), vf.to(dtype), None, None
    return dict(q=t(rng.randn(S, Q, H, Dh).astype(np.float32), dtype),
                k_pool=k, v_pool=v, tables=t(tables, torch.int32),
                pos=t(pos, torch.int32), k_scale=ks, v_scale=vs)


BF, F32 = torch.bfloat16, torch.float32
# dtype, int8 pool, Q, H, KVH, Dh, bs, MB
K5_KERNEL_CASES = {
    "f32_q1": (F32, False, 1, 16, 4, 64, 32, 8),
    "bf16_q1": (BF, False, 1, 16, 4, 64, 32, 8),
    "bf16_q4": (BF, False, 4, 16, 4, 64, 32, 8),
    "f32_int8_q3_g4": (F32, True, 3, 8, 2, 64, 32, 8),
    "bf16_int8_q1": (BF, True, 1, 16, 4, 64, 32, 8),
    "f32_q2_mha": (F32, False, 2, 4, 4, 64, 32, 8),
    # head_dim 128 (the 470m-hd128 heads), in bf16 and int8
    "bf16_d128": (BF, False, 1, 8, 2, 128, 32, 8),
    "bf16_int8_d128_q2": (BF, True, 2, 8, 2, 128, 32, 8),
    # head_dim 16 through the generic form (the on-card engine test's)
    "bf16_d16_q2": (BF, False, 2, 8, 2, 16, 8, 8),
    "f32_d16": (F32, False, 1, 8, 2, 16, 8, 8),
    # 40 blocks of 16 keys: a warp walks two blocks, the ring wraps
    "bf16_bs16_mb40": (BF, False, 1, 16, 4, 64, 16, 40),
    "bf16_int8_bs16_mb40_q2": (BF, True, 2, 16, 4, 64, 16, 40),
    "f32_bs16_mb40": (F32, False, 1, 16, 4, 64, 16, 40),
    # Q * G = 24 rows: two 16-row tiles
    "bf16_q3_g8_rows24": (BF, False, 3, 16, 2, 64, 32, 8),
    "f32_q3_g8_rows24": (F32, False, 3, 16, 2, 64, 32, 8),
}


@pytest.mark.parametrize("case", list(K5_KERNEL_CASES))
def test_paged_attention_kernel_matches_plain(cuda_device, case):
    dtype, quant, Q, H, KVH, Dh, bs, MB = K5_KERNEL_CASES[case]
    inp = _inputs(cuda_device, dtype, Q, quant, H=H, KVH=KVH, Dh=Dh, bs=bs,
                  MB=MB)
    before = PA.launches
    got = PA.paged_attention_queries(**inp)
    torch.cuda.synchronize()
    assert PA.launches == before + 1
    want = PA.paged_attention_queries_ref(**inp)
    # f32: summation order only; bf16: p is rounded to bf16 before the PV
    # product in the kernel (as in the TPU kernel), not in the plain one
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", ["bf16_q1", "bf16_bs16_mb40", "f32_q1",
                                  "bf16_int8_d128_q2"])
def test_paged_attention_repeats_bitwise(cuda_device, case):
    """Two launches on the same inputs give the same bits: the cluster
    merges its ranks in a fixed order, with no atomics."""
    dtype, quant, Q, H, KVH, Dh, bs, MB = K5_KERNEL_CASES[case]
    inp = _inputs(cuda_device, dtype, Q, quant, H=H, KVH=KVH, Dh=Dh, bs=bs,
                  MB=MB)
    first = PA.paged_attention_queries(**inp)
    second = PA.paged_attention_queries(**inp)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_paged_attention_kernel_rejects_bad_inputs(cuda_device):
    inp = _inputs(cuda_device, torch.bfloat16, 1, False)
    with pytest.raises(TypeError):
        PA.paged_attention_queries(**dict(inp, pos=inp["pos"].long()))
    with pytest.raises(ValueError):
        PA.paged_attention_queries(**dict(inp, tables=inp["tables"].cpu()))
    with pytest.raises(ValueError):
        PA.paged_attention_queries(**dict(inp, q=inp["q"].transpose(2, 3)))


@pytest.mark.parametrize("extra", [{}, {"speculative": 3},
                                   {"kv_dtype": torch.int8}],
                         ids=["chunked", "speculative", "int8"])
def test_engine_fused_matches_gather_on_card(cuda_device, extra):
    """In f32 the kernel and the gather path agree to summation order, so
    greedy tokens match: chunked decode, the multi-query verify and the
    int8 pool."""
    cfg = G.GPTConfig(vocab_size=256, d_model=128, n_heads=8, n_kv_heads=2,
                      n_layers=2, d_ff=256, max_seq=256, rope=True,
                      mlp="swiglu", dtype=torch.float32)
    params = G.init_params(torch.Generator(device=cuda_device)
                           .manual_seed(0), cfg)
    rng = np.random.RandomState(1)
    reqs = [dict(uid=i, prompt=(rng.randint(0, 256, 5).tolist() * 20)[:n],
                 max_new=12) for i, n in enumerate((3, 17, 40, 70, 9))]
    out = {}
    for attend in ("fused", "gather"):
        eng = DecodeEngine(params, cfg, device=cuda_device, attend=attend,
                           num_slots=3, block_size=8, num_blocks=64,
                           prompt_buckets=(16, 128), decode_chunk=4,
                           **extra)
        before = PA.launches
        out[attend] = eng.run([Request(**r) for r in reqs])
        launched = PA.launches - before
        assert (launched > 0) == (attend == "fused")
    assert out["fused"] == out["gather"]


# ------------------------------------------------- K1-K4 (flash attention)
# The cases, the inputs and the error measure are chip_smoke.py's, so the
# smoke run and these tests hold the kernels to the same limits.
@pytest.mark.parametrize("name", list(chip_smoke.FLASH_CASES))
def test_flash_kernels_match_plain(cuda_device, name):
    """out, lse, dq, dk, dv through K1-K4 against autograd through the
    plain version, within chip_smoke.FLASH_TOL: the largest error over
    the largest value, and the relative error of every 64-row tile."""
    before = dict(FA.launches)
    errs = chip_smoke.flash_case(cuda_device, name)
    assert all(FA.launches[n] == before[n] + 1 for n in FA.launches)
    assert chip_smoke.flash_over(errs, chip_smoke.FLASH_CASES[name][7]) == {}


@pytest.mark.parametrize("H,KVH,D", [(16, 4, 64), (8, 2, 128), (16, 1, 64)],
                         ids=["470m", "470m_hd128", "mqa_g16"])
def test_flash_backward_repeats_bitwise(cuda_device, H, KVH, D):
    """K3 and K4 launched twice on the same inputs give the same bits:
    K4 sums a KV head's query heads through its cluster in a fixed rank
    order, with no atomics, and K3 writes each dq once."""
    B, T, g = 2, 512, H // KVH
    q, k, v, do, _ = chip_smoke.flash_inputs(cuda_device, B, T, T, H, KVH, D,
                                             torch.bfloat16, seed=3)
    out, lse = FA.flash_forward(q, k, v, True, g)
    delta = FA.flash_delta(out, do)
    runs = [(FA.flash_bwd_dq(q, k, v, do, lse, delta, True, g),
             *FA.flash_bwd_dkv(q, k, v, do, lse, delta, True, g))
            for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


def _delta_inputs(device, D, dt, strided, B=2, T=300, H=4):
    """out and dout [B, T, H, D]; ``strided``: out a view of a
    [B, H, T, D] tensor and dout one of a wider last dimension (rows
    stay 16-byte aligned, as the kernel needs)."""
    g = torch.Generator(device=device).manual_seed(D + strided)
    mk = lambda *s: torch.randn(s, generator=g, device=device).to(
        chip_smoke._DT[dt])
    if not strided:
        return mk(B, T, H, D), mk(B, T, H, D)
    return mk(B, H, T, D).transpose(1, 2), mk(B, T, H, D + 16)[..., :D]


@pytest.mark.parametrize("strided", [False, True],
                         ids=["contiguous", "strided"])
@pytest.mark.parametrize("with_dlse", [False, True],
                         ids=["no_dlse", "dlse"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_delta_matches_plain(cuda_device, D, dt, with_dlse, strided):
    """K2 against its plain version within the f32 limits (a ragged T, so
    the last warp's rows run past the end)."""
    out, dout = _delta_inputs(cuda_device, D, dt, strided)
    B, T, H, _ = out.shape
    dlse = (torch.randn((B, H, T), device=cuda_device) if with_dlse
            else None)
    before = FA.launches["fa_delta"]
    got = FA.flash_delta(out, dout, dlse)
    torch.cuda.synchronize()
    assert FA.launches["fa_delta"] == before + 1
    errs = {"delta": chip_smoke.flash_errors(
        "delta", got, FA._delta_plain(out, dout, dlse))}
    assert chip_smoke.flash_over(errs, dt) == {}


@pytest.mark.parametrize("D", [64, 128])
def test_flash_delta_repeats_bitwise(cuda_device, D):
    out, dout = _delta_inputs(cuda_device, D, "bf16", False, T=2048, H=16)
    first = FA.flash_delta(out, dout)
    second = FA.flash_delta(out, dout)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_kernels_reject_bad_inputs(cuda_device):
    q, k, v, do, _ = chip_smoke.flash_inputs(cuda_device, 1, 64, 64, 4, 2,
                                             64, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_forward(q[..., :32].contiguous(), k[..., :32].contiguous(),
                         v[..., :32].contiguous(), True, 2)
    with pytest.raises(TypeError):
        FA.flash_forward(q.half(), k.half(), v.half(), True, 2)
    with pytest.raises(TypeError):
        FA.flash_forward(q, k.float(), v, True, 2)
    with pytest.raises(ValueError):
        FA.flash_forward(q, k.cpu(), v, True, 2)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_forward(q.transpose(2, 3).contiguous().transpose(2, 3),
                         k, v, True, 2)
    out, lse = FA.flash_forward(q, k, v, True, 2)
    with pytest.raises(ValueError, match="row statistic"):
        FA.flash_bwd_dq(q, k, v, do, lse.transpose(1, 2), lse, True, 2)


# ------------------------------------------------------ K6 (no softmax)
# chip_smoke.py's K6 cases, inputs and measure (the roofline's three K6
# shapes and a ragged T), held to the flash bf16 limits.
@pytest.mark.parametrize("name", list(chip_smoke.NOSOFTMAX_CASES))
def test_nosoftmax_kernel_matches_plain(cuda_device, name):
    before = RL.launches["nosoftmax"]
    errs, _, _, _ = chip_smoke.nosoftmax_case(cuda_device, name)
    assert RL.launches["nosoftmax"] == before + 1
    assert chip_smoke.flash_over({"out": errs}, "bf16") == {}


def test_nosoftmax_kernel_rejects_bad_inputs(cuda_device):
    q, k, v = chip_smoke.nosoftmax_inputs(cuda_device, 1, 128, 2, 64, seed=0)
    with pytest.raises(ValueError, match="blocks"):
        RL.nosoftmax_attention(q, k, v, True, bq=128, bk=128)
    with pytest.raises(TypeError):
        RL.nosoftmax_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim"):
        RL.nosoftmax_attention(q[..., :32].contiguous(),
                               k[..., :32].contiguous(),
                               v[..., :32].contiguous())
    with pytest.raises(ValueError):
        RL.nosoftmax_attention(q, k.cpu(), v)
