"""The port's training path against the JAX package's, on the CPU.

A tiny GPT (2 layers, d_model 32, 4 heads) trains for 3 steps through
``forward_features(attn="flash")`` + chunked CE under the synchronous-SGD
AdamW step with 2 accumulation microbatches, from the same converted
parameters and the same global batch, in the port and in JAX
(``build_train_step`` on ``flat_mesh``).  One rank runs in this process
(gloo, world 1); the two-rank case spawns two processes that meet through
a FileStore.

Tolerances: f32 losses 1e-5 (summation order); f32 parameters 2e-5
absolute (AdamW divides by sqrt(v), which amplifies the summation-order
noise of a gradient near 0: at lr 1e-2 one weight in ~20000 moved 3e-5
apart, at lr 1e-3 the largest gap is ~3e-6).  bf16 compute: losses 2e-2
(bf16 rounding of activations and gradients at other places in the two
frameworks); parameters lr / 2 for all but 1% of them, and at most
2 x lr x steps for any (AdamW moves a weight by about +-lr per step
whatever its gradient's size, so a gradient within bf16 rounding of 0
may step the other way).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kungfu_tpu.optimizers as kfopt
from kungfu_tpu.comm.mesh import flat_mesh as jflat_mesh
from kungfu_tpu.models import gpt as JG
from kungfu_tpu.ops.chunked_ce import chunked_cross_entropy as jce
from kungfu_tpu.training import (build_train_step as jbuild,
                                 init_opt_state, replicate)
from kungfu_tpu_torch import ops as TO
from kungfu_tpu_torch.benchmarks.gpt import solo_group
from kungfu_tpu_torch.comm import collectives as TC
from kungfu_tpu_torch.comm.mesh import flat_mesh
from kungfu_tpu_torch.convert import params_from_jax
from kungfu_tpu_torch.models import gpt as TG
from kungfu_tpu_torch.ops.chunked_ce import chunked_cross_entropy as tce
from kungfu_tpu_torch.optimizers import synchronous_sgd
from kungfu_tpu_torch.training import (broadcast_variables,
                                       build_train_step, lane_mean)
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LR, STEPS, CHUNK = 1e-3, 3, 32
CASES = {
    "swiglu-rope-gqa": dict(mlp="swiglu", rope=True, n_kv_heads=2),
    "gelu-wpe-mha": dict(mlp="gelu", rope=False, n_kv_heads=None),
}


def _cfgs(case, jdtype=jnp.float32, tdtype=torch.float32):
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=16, **CASES[case])
    return JG.GPTConfig(dtype=jdtype, **kw), TG.GPTConfig(dtype=tdtype, **kw)


def _batch(B=4, T=16, V=64, seed=1):
    toks = np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _jax_train(jcfg, jp, toks, tgts, n=1, accum=2, compute_dtype=None,
               steps=STEPS):
    def loss_fn(p, batch):
        bt, by = batch
        feats = JG.forward_features(p, bt, jcfg, attn="flash")
        return jce(feats, p["lm_head"].astype(jcfg.dtype), by,
                   CHUNK).mean()

    mesh = jflat_mesh(n=n)
    opt = kfopt.synchronous_sgd(optax.adamw(LR))
    sp = replicate(jp, mesh)
    st = init_opt_state(opt, sp, mesh)
    step = jbuild(loss_fn, opt, mesh, donate=False, accum_steps=accum,
                  compute_dtype=compute_dtype)
    losses = []
    for _ in range(steps):
        sp, st, loss = step(sp, st, (jnp.asarray(toks), jnp.asarray(tgts)))
        losses.append(float(np.asarray(loss)[0]))
    return losses, jax.tree_util.tree_map(lambda t: np.asarray(t)[0], sp)


def _torch_loss_fn(tcfg, attn="flash", remat=False):
    def loss_fn(p, batch):
        bt, by = batch
        feats = TG.forward_features(p, bt, tcfg, attn=attn, remat=remat)
        return tce(feats, p["lm_head"].to(tcfg.dtype), by, CHUNK).mean()
    return loss_fn


def _torch_train(tcfg, tp, toks, tgts, accum=2, compute_dtype=None,
                 steps=STEPS):
    group = flat_mesh()
    broadcast_variables(tp, group)
    opt = synchronous_sgd(torch.optim.AdamW(
        tree_leaves(tp), lr=LR, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4), group)
    step = build_train_step(_torch_loss_fn(tcfg), opt, tp, group,
                            accum_steps=accum, compute_dtype=compute_dtype)
    batch = (torch.from_numpy(toks), torch.from_numpy(tgts))
    return [float(step(batch)) for _ in range(steps)], tp


def _assert_f32_params_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def _flat(tree):
    return np.concatenate([np.asarray(t, np.float32).reshape(-1)
                           for t in jax.tree_util.tree_leaves(tree)])


def _tflat(tree):
    return np.concatenate([t.detach().numpy().reshape(-1)
                           for t in tree_leaves(tree)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax_f32(case):
    jcfg, tcfg = _cfgs(case)
    jp = JG.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    toks, tgts = _batch()
    jl, jparams = _jax_train(jcfg, jp, toks, tgts)
    with solo_group(CPU):
        tl, tparams = _torch_train(tcfg, tp, toks, tgts)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    # the same leaves in the same (sorted-key) order on both sides
    _assert_f32_params_close(_tflat(tparams), _flat(jparams))
    assert all(t.dtype == torch.float32 for t in tree_leaves(tparams))


def test_train_steps_match_jax_bf16_compute():
    case = "swiglu-rope-gqa"
    jcfg, tcfg = _cfgs(case, jnp.bfloat16, torch.bfloat16)
    jp = JG.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    init = _tflat(tp)
    toks, tgts = _batch()
    jl, jparams = _jax_train(jcfg, jp, toks, tgts,
                             compute_dtype=jnp.bfloat16)
    with solo_group(CPU):
        tl, tparams = _torch_train(tcfg, tp, toks, tgts,
                                   compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)
    got, want = _tflat(tparams), _flat(jparams)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tparams))
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * STEPS
    assert np.mean(diff > LR / 2) <= 0.01
    assert np.abs(got - init).max() > LR          # the steps did move it


@pytest.mark.parametrize("remat", ["full", "ffn", "attn"])
def test_remat_modes_give_the_no_remat_grads(remat):
    _, tcfg = _cfgs("swiglu-rope-gqa")
    tp = TG.init_params(torch.Generator().manual_seed(3), tcfg)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    toks, tgts = _batch(B=2)
    batch = (torch.from_numpy(toks), torch.from_numpy(tgts))
    want = torch.autograd.grad(_torch_loss_fn(tcfg)(tp, batch), leaves)
    got = torch.autograd.grad(_torch_loss_fn(tcfg, remat=remat)(tp, batch),
                              leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        _torch_loss_fn(tcfg, remat="bogus")(tp, batch)


def test_flash_and_dense_attends_agree_in_the_model():
    _, tcfg = _cfgs("swiglu-rope-gqa")
    tp = TG.init_params(torch.Generator().manual_seed(4), tcfg)
    toks = torch.from_numpy(_batch(B=2)[0])
    a = TG.forward_local(tp, toks, tcfg, attn="flash")
    b = TG.forward_local(tp, toks, tcfg, attn="dense")
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(TG.forward_local(tp, toks, tcfg), b)  # auto
    loss = TG.loss_fn(tp, toks, torch.roll(toks, -1, 1), tcfg)
    ref = torch.nn.functional.cross_entropy(
        b.reshape(-1, 64), torch.roll(toks, -1, 1).reshape(-1).long())
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-5)


# ----------------------------------------- the test_optimizers.py cases
def _quad_loss(p, batch):
    bx, by = batch
    w = p["w"]
    return torch.mean(((bx.to(w.dtype) @ w - by.to(w.dtype)).float()) ** 2)


def test_gradient_accumulation_matches_big_batch():
    rng = np.random.RandomState(0)
    w0 = rng.randn(8, 2).astype(np.float32)
    x = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    y = torch.from_numpy(rng.randn(16, 2).astype(np.float32))
    ref = torch.from_numpy(w0.copy()).requires_grad_(True)
    _quad_loss({"w": ref}, (x, y)).backward()
    want = ref.detach() - 0.1 * ref.grad
    params = {"w": torch.from_numpy(w0.copy())}
    with solo_group(CPU):
        opt = synchronous_sgd(torch.optim.SGD([params["w"]], lr=0.1))
        step = build_train_step(_quad_loss, opt, params, accum_steps=2)
        loss = step((x, y))
    torch.testing.assert_close(params["w"], want, rtol=1e-5, atol=1e-6)
    assert torch.isfinite(loss)


def test_gradient_accumulation_rejects_bad_split():
    params = {"w": torch.zeros(4, 2)}
    with solo_group(CPU):
        opt = synchronous_sgd(torch.optim.SGD([params["w"]], lr=0.1))
        with pytest.raises(ValueError):
            build_train_step(_quad_loss, opt, params, accum_steps=0)
        step = build_train_step(_quad_loss, opt, params, accum_steps=3)
        with pytest.raises(ValueError, match="not divisible"):
            step((torch.zeros(4, 4), torch.zeros(4, 2)))


def test_compute_dtype_master_weights_accumulate_f32():
    """bf16 compute: the f32 master stays f32 and near the f32 run."""
    rng = np.random.RandomState(1)
    w0 = rng.randn(8, 2).astype(np.float32)
    x = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    y = torch.from_numpy(rng.randn(16, 2).astype(np.float32))

    def run(compute_dtype):
        params = {"w": torch.from_numpy(w0.copy())}
        opt = synchronous_sgd(torch.optim.SGD([params["w"]], lr=0.05))
        step = build_train_step(_quad_loss, opt, params, accum_steps=4,
                                compute_dtype=compute_dtype)
        for _ in range(3):
            step((x, y))
        return params["w"]

    with solo_group(CPU):
        got, ref = run(torch.bfloat16), run(None)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)


# ------------------------------------------------ collectives, one rank
def test_collectives_and_fusion_on_one_rank():
    tree = {"b": torch.arange(6.).reshape(2, 3), "a": [torch.ones(4),
                                                        torch.arange(3)]}
    flat, spec = TO.fuse(tree)
    assert sorted(flat) == ["torch.float32", "torch.int64"]
    back = TO.defuse(flat, spec)
    for x, y in zip(tree_leaves(back), tree_leaves(tree)):
        assert torch.equal(x, y)
    with solo_group(CPU):
        for op in ("SUM", "MEAN", "MIN", "MAX", "PROD"):
            out = TC.all_reduce(tree, op=op)
            assert all(torch.equal(x, y) for x, y in zip(
                tree_leaves(out), tree_leaves(tree)))
        fused = TO.fused_all_reduce(tree, op="SUM")
        assert torch.equal(fused["b"], tree["b"])
        assert TC.all_gather(tree["b"]).shape == (1, 2, 3)
        assert TO.peer_info() == (0, 1)
        out, nbytes = TO.monitored_all_reduce(tree["b"])
        assert nbytes == 6 * 4 and torch.equal(out, tree["b"])
        assert torch.equal(lane_mean(tree)["b"], tree["b"])
        with pytest.raises(ValueError, match="unknown op"):
            TC.all_reduce(tree["b"], op="AVG")
    with pytest.raises(RuntimeError, match="no process group"):
        flat_mesh()


# ------------------------------------------------------------- two ranks
WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import ops as TO
    from kungfu_tpu_torch.comm import collectives as TC
    from kungfu_tpu_torch.comm.mesh import flat_mesh, init_process_group_file
    from kungfu_tpu_torch.models import gpt as TG
    from kungfu_tpu_torch.ops.chunked_ce import chunked_cross_entropy
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.training import (broadcast_variables,
                                           build_train_step)
    from kungfu_tpu_torch.utils.tree import tree_leaves

    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    init_process_group_file(store, rank, 2, "gloo")
    group = flat_mesh(n=2)
    d = np.load(inp)
    # collectives on integer-valued f32 (exact): rank r holds x + 10 r
    x = torch.from_numpy(d["x"]) + 10 * rank
    res = {f"ar_{op}": TC.all_reduce(x, group, op).numpy()
           for op in ("SUM", "MEAN", "MIN", "MAX", "PROD")}
    res["gather"] = TC.all_gather(x, group).numpy()
    res["gather_tiled"] = TC.all_gather(x, group, tiled=True).numpy()
    res["rs"] = TC.reduce_scatter(x, group).numpy()
    res["bc"] = TC.broadcast(x, group, root=1).numpy()
    res["root"] = TC.reduce_to_root(x, group, root=0).numpy()
    # two levels: each rank alone (inner), then across the two (outer)
    singles = [dist.new_group([0]), dist.new_group([1])]
    res["hier"] = TC.hierarchical_all_reduce(x, singles[rank], group,
                                             "SUM").numpy()
    res["fused"] = TO.fused_all_reduce([x, x[0]], group, "MEAN")[0].numpy()
    # the tiny GPT: rank 1 starts from other weights; the broadcast from
    # rank 0 aligns them
    cfg = TG.GPTConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq=16, mlp="swiglu", rope=True,
                       n_kv_heads=2, dtype=torch.float32)
    params = TG.init_params(torch.Generator().manual_seed(rank), cfg)
    flat = [torch.from_numpy(d[f"p{i}"]) for i in range(len(tree_leaves(
        params)))]
    if rank == 0:
        for t, v in zip(tree_leaves(params), flat):
            t.copy_(v)
    broadcast_variables(params, group)

    def loss_fn(p, batch):
        bt, by = batch
        feats = TG.forward_features(p, bt, cfg, attn="flash")
        return chunked_cross_entropy(feats, p["lm_head"], by, 32).mean()

    opt = synchronous_sgd(torch.optim.AdamW(
        tree_leaves(params), lr=float(d["lr"]), betas=(0.9, 0.999),
        eps=1e-8, weight_decay=1e-4), group,
        fusion=bool(int(d["fusion"])))
    step = build_train_step(loss_fn, opt, params, group, accum_steps=2)
    batch = (torch.from_numpy(d["toks"]), torch.from_numpy(d["tgts"]))
    res["losses"] = np.array([float(step(batch)) for _ in range(3)])
    for i, t in enumerate(tree_leaves(params)):
        res[f"p{i}"] = t.numpy()
    np.savez(out, **res)
""")


@pytest.mark.parametrize("fusion", [False, True], ids=["plain", "fused"])
def test_two_rank_sync_sgd_matches_jax(tmp_path, fusion):
    jcfg, tcfg = _cfgs("swiglu-rope-gqa")
    jp = JG.init_params(jax.random.PRNGKey(0), jcfg)
    toks, tgts = _batch(B=8)
    x = np.arange(12, dtype=np.float32).reshape(4, 3) + 1
    leaves = [np.asarray(t) for t in jax.tree_util.tree_leaves(jp)]
    np.savez(tmp_path / "in.npz", x=x, toks=toks, tgts=tgts,
             fusion=np.int32(fusion), lr=np.float64(LR),
             **{f"p{i}": a for i, a in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(tmp_path / "store"),
         str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    r0, r1 = (np.load(tmp_path / f"out{r}.npz") for r in range(2))
    xs = np.stack([x, x + 10])
    want = {"ar_SUM": xs.sum(0), "ar_MEAN": xs.mean(0), "ar_MIN": xs.min(0),
            "ar_MAX": xs.max(0), "ar_PROD": xs.prod(0), "gather": xs,
            "gather_tiled": xs.reshape(8, 3), "bc": x + 10,
            "hier": xs.sum(0), "fused": xs.mean(0)}
    for r, res in enumerate((r0, r1)):
        for key, w in want.items():
            np.testing.assert_array_equal(res[key], w, err_msg=key)
        np.testing.assert_array_equal(res["rs"], xs.sum(0)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            res["root"], xs.sum(0) if r == 0 else np.zeros_like(x))
    # sync SGD keeps the replicas identical, and matches JAX on 2 lanes
    n = len(leaves)
    for i in range(n):
        np.testing.assert_array_equal(r0[f"p{i}"], r1[f"p{i}"])
    jl, jparams = _jax_train(jcfg, jp, toks, tgts, n=2)
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5, atol=1e-5)
    got = np.concatenate([r0[f"p{i}"].reshape(-1) for i in range(n)])
    _assert_f32_params_close(got, _flat(jparams))


# -------------------------------------------------- the benchmark entry
SMALL = ["--device", "cpu", "--d-model", "32", "--n-layers", "2",
         "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "64", "--vocab",
         "64", "--seq", "16", "--rope", "--swiglu"]


def test_benchmark_trains_on_cpu_and_prints_one_json_line(capsys):
    import json
    from kungfu_tpu_torch.benchmarks import gpt as BG
    assert BG.main(SMALL + ["--batch", "4", "--accum", "2", "--steps", "2",
                            "--warmup-steps", "1", "--chunked-ce", "32",
                            "--attn", "flash", "--f32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "gpt_tokens_per_sec_per_chip"
    assert out["backend"] == "cpu" and out["device"] == "cpu"
    assert out["value"] > 0 and np.isfinite(out["loss"])
    args = BG.parse_args(["--preset", "470m", "--n-layers", "2"])
    assert (args.d_model, args.n_layers, args.accum, args.chunked_ce) == \
        (1024, 2, 32, 16384)          # explicit flags win over the preset
    with pytest.raises(SystemExit, match="accum"):
        BG.main(SMALL + ["--batch", "4", "--accum", "3"])


def test_benchmark_decode_on_cpu(capsys):
    import json
    from kungfu_tpu_torch.benchmarks import gpt as BG
    assert BG.main(SMALL + ["--decode", "--batch", "2", "--steps", "1",
                            "--prompt-len", "4", "--f32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "gpt_decode_tokens_per_sec_per_chip"
    assert out["new_tokens"] == 12
    with pytest.raises(SystemExit, match="training only"):
        BG.main(SMALL + ["--decode", "--accum", "2"])


def test_benchmark_defaults_to_the_card():
    """Without --device the entry point asks for cuda and raises when
    there is none; it never falls back to the CPU."""
    from kungfu_tpu_torch.benchmarks import gpt as BG
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BG.main(SMALL[2:] + ["--steps", "1"])
