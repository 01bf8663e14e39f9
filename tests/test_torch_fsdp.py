"""The port's ZeRO-3 and ZeRO-1 steps against JAX's.

Four gloo ranks, spawned once for the module, run
``kungfu_tpu_torch.parallel.fsdp``'s ``make_fsdp_step``,
``make_fsdp_scan_step`` and ``make_zero1_step`` on every case below; the
test side runs ``kungfu_tpu.parallel.fsdp``'s on a 4-device mesh of the
conftest's virtual devices, on the same numpy-seeded inputs.  Each
rank's losses and its chunk of the flat state must equal JAX's (f32).
The cases port tests/test_parallel.py (FSDP under SGD, FSDP's Adam
scalar state, ZeRO-1 against one device's Adam) and
tests/test_fsdp_scan.py (the trajectory, the step without remat, and the
memory profile, here as the bytes of gathered parameter copies alive at
once, ``fsdp.gathered``), and add a small GPT through the scan contract
and two planted faults (a reduce-scatter without the mean, one rank's
gather in reverse rank order), each of which must fail the comparison.
"""
import functools
import json
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
from jax.sharding import Mesh

from kungfu_tpu.models import gpt as JG
from kungfu_tpu.ops.chunked_ce import chunked_cross_entropy as jax_chunked_ce
from kungfu_tpu.parallel import (make_fsdp_scan_step, make_fsdp_step,
                                 make_zero1_step)
from kungfu_tpu_torch.examples.ranks import launch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
# f32 parity with JAX (tests/test_parallel.py's and tests/test_fsdp_scan.py's
# limits against one device)
LOSS_RTOL = 2e-5
TOL = {"rtol": 1e-5, "atol": 1e-6}
# Adam trajectories across the two frameworks: torch's Adam and optax's
# round their updates differently, and Adam's normalised step carries an
# ulp of difference in a small gradient into the parameters.  The one
# -process torch run of scan_trajectory is 3.2e-5 (relative) from JAX's
# by step 4, exactly as far as the port's sharded run is, so the limits
# are tests/test_torch_gpt3d.py's for its Adam cases, and the sharded run
# is held to its own one-process run at LOSS_RTOL and TOL
# (test_scan_matches_one_process).
ADAM = {"loss_rtol": 1e-4, "tol": {"rtol": 2e-4, "atol": 2e-5}}
# scan_trajectory's Adam at lr 0.05 over a loss that jumps from 1.3 to 11:
# the one-process torch run's parameters end 5.68e-5 (absolute) from
# JAX's, so its parameters are held to JAX at 1e-4
ADAM_LR05 = {"loss_rtol": 1e-4, "tol": {"rtol": 2e-4, "atol": 1e-4}}
D_MODEL = 64                     # tests/test_fsdp_scan.py's width
GPT = dict(vocab_size=64, d_model=32, n_heads=2, n_kv_heads=1, n_layers=3,
           d_ff=64, max_seq=16, rope=True, mlp="swiglu")
GPT_CHUNK = 16                   # vocabulary chunk of the chunked CE
WEIGHT_DECAY = 0.1               # AdamW's, on both sides


def _case(kind, model, opt, lr, steps, L=None, remat=True, fault=None):
    return {"kind": kind, "model": model, "opt": opt, "lr": lr,
            "steps": steps, "L": L, "remat": remat, "fault": fault}


CASES = {
    # tests/test_parallel.py:63, :101, :157
    "fsdp_sgd": _case("flat", "linear_b", "sgd", 0.1, 3),
    "fsdp_adam_scalar": _case("flat", "linear", "adam", 1e-2, 2),
    "zero1_adam": _case("zero1", "linear_b10", "adam", 1e-2, 3),
    # 33 parameters padded to 36: the tail stays zero under AdamW's decay
    "fsdp_adamw_padded": _case("flat", "linear_b10", "adamw", 1e-2, 3),
    # tests/test_fsdp_scan.py:86, :189
    "scan_trajectory": _case("scan", "stack", "adam", 0.05, 5, L=4),
    "scan_remat": _case("scan", "stack", "sgd", 0.1, 1, L=3),
    "scan_no_remat": _case("scan", "stack", "sgd", 0.1, 1, L=3,
                           remat=False),
    # the GPT through the scan contract
    "gpt_adam": _case("scan", "gpt", "adam", 1e-2, 3),
    "gpt_sgd": _case("scan", "gpt", "sgd", 0.1, 1),
    "gpt_sgd_no_mean": _case("scan", "gpt", "sgd", 0.1, 1, fault="no_mean"),
    "gpt_sgd_reversed": _case("scan", "gpt", "sgd", 0.1, 1,
                              fault="reversed"),
    # tests/test_fsdp_scan.py:117, :161: gathered bytes alive at once
    "mem_scan_16": _case("scan", "stack", "adam", 0.05, 1, L=16),
    "mem_flat_16": _case("flat", "stack", "adam", 0.05, 1, L=16),
    "mem_scan_8": _case("scan", "stack", "adam", 0.05, 1, L=8),
    "mem_scan_32": _case("scan", "stack", "adam", 0.05, 1, L=32),
}
FAULTS = {"gpt_sgd_no_mean": "gpt_sgd", "gpt_sgd_reversed": "gpt_sgd"}
_EXAMPLE = []                    # the example's process, run beside the ranks


# ------------------------------------------------ inputs (numpy, seeded)
def _linear_inputs(model):
    """tests/test_parallel.py's parameters and batch, by model."""
    if model == "linear_b":
        rng = np.random.RandomState(0)
        params = {"w": rng.randn(16, 4).astype(np.float32),
                  "b": np.zeros((4,), np.float32)}
        x = rng.randn(32, 16).astype(np.float32)
        y = rng.randn(32, 4).astype(np.float32)
    elif model == "linear":
        rng = np.random.RandomState(2)
        params = {"w": rng.randn(8, 3).astype(np.float32)}
        x = rng.randn(16, 8).astype(np.float32)
        y = rng.randn(16, 3).astype(np.float32)
    else:                                   # linear_b10
        rng = np.random.RandomState(3)
        params = {"w": rng.randn(10, 3).astype(np.float32),
                  "b": np.zeros((3,), np.float32)}
        x = rng.randn(16, 10).astype(np.float32)
        y = rng.randn(16, 3).astype(np.float32)
    return params, (x, y)


def _stack_inputs(L):
    """tests/test_fsdp_scan.py's model: params and an 8-row batch."""
    rng = np.random.RandomState(0)
    f = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)
    params = {"embed": {"w_in": f(16, D_MODEL)},
              "layers": {"w": f(L, D_MODEL, D_MODEL),
                         "b": np.zeros((L, D_MODEL), np.float32)},
              "head": {"w_out": f(D_MODEL, 4)}}
    rng = np.random.RandomState(1)
    batch = (rng.randn(2 * WORLD, 16).astype(np.float32),
             rng.randn(2 * WORLD, 4).astype(np.float32))
    return params, batch


def _jcfg():
    return JG.GPTConfig(**GPT, dtype=jnp.float32)


def _gpt_inputs():
    """JAX's GPT init, split into the scan contract's pieces (layers
    stacked), and an 8 x 8 token batch."""
    full = JG.init_params(jax.random.PRNGKey(0), _jcfg())
    layers = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *full["layers"])
    params = {"embed": {"wte": full["wte"]},
              "layers": layers,
              "head": {"lnf": full["lnf"], "lm_head": full["lm_head"]}}
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, GPT["vocab_size"], (8, 8)).astype(np.int32)
    targets = rng.randint(0, GPT["vocab_size"], (8, 8)).astype(np.int32)
    return params, (tokens, targets)


def _inputs(case):
    if case["model"] == "gpt":
        return _gpt_inputs()
    if case["model"] == "stack":
        return _stack_inputs(case["L"])
    return _linear_inputs(case["model"])


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten(t, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


WORKER = textwrap.dedent("""
    import gc, json, sys, weakref
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.models import gpt as G
    from kungfu_tpu_torch.ops.chunked_ce import chunked_cross_entropy
    from kungfu_tpu_torch.parallel import fsdp as FS
    from kungfu_tpu_torch.utils.tree import tree_leaves

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    init_process_group_file(f"{tmp}/store", rank, world, "gloo",
                            timeout_s=120)
    plan = json.load(open(f"{tmp}/plan.json"))
    flat = dict(np.load(f"{tmp}/in.npz"))
    cfg = G.GPTConfig(**plan["gpt"], dtype=torch.float32)
    chunk = plan["chunk"]

    def tree(prefix):
        out = {}
        for key, v in flat.items():
            if key.startswith(prefix + "/"):
                *path, leaf = key[len(prefix) + 1:].split("/")
                node = out
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = torch.from_numpy(v)
        return out

    # tests/test_parallel.py's and tests/test_fsdp_scan.py's models
    def linear_loss(p, b):
        pred = b[0] @ p["w"] + (p["b"] if "b" in p else 0.0)
        return ((pred - b[1]) ** 2).mean()

    def embed(ep, b):
        return torch.tanh(b[0] @ ep["w_in"])

    def layer(lp, a):
        return a + torch.tanh(a @ lp["w"] + lp["b"])

    def head(hp, a, b):
        return ((a @ hp["w_out"] - b[1]) ** 2).mean()

    def stack_loss(p, b):
        a = embed(p["embed"], b)
        for i in range(p["layers"]["w"].shape[0]):
            a = layer({k: v[i] for k, v in p["layers"].items()}, a)
        return head(p["head"], a, b)

    # the GPT's pieces under the scan contract (dense attention, f32)
    def gpt_embed(ep, b):
        T = b[0].shape[1]
        return G.embed(ep, b[0].long(), torch.arange(T)[None], cfg)

    def gpt_layer(lp, x):
        return G.apply_layer(lp, x, cfg, attn="dense")

    def gpt_head(hp, x, b):
        x = G.rms_norm(x, hp["lnf"])
        return chunked_cross_entropy(x, hp["lm_head"], b[1].long(),
                                     chunk).mean()

    def reversed_gather(orig):
        def run(t, group):
            out = orig(t, group)
            n = dist.get_world_size(group)
            return torch.cat(out.chunk(n)[::-1]) if rank == 1 else out
        return run

    def named(t, prefix):
        return {f"{prefix}/{k}": v.detach().numpy() for k, v in t.items()}

    res = {}
    for name, case in plan["cases"].items():
        params = tree(f"in/{plan['inputs'][name]}/params")
        batch = tuple(torch.from_numpy(flat[f"in/{plan['inputs'][name]}/batch/{i}"])
                      for i in range(2))
        lr = case["lr"]
        make_opt = {
            "sgd": lambda ps: torch.optim.SGD(ps, lr=lr),
            "adam": lambda ps: torch.optim.Adam(ps, lr=lr),
            "adamw": lambda ps: torch.optim.AdamW(
                ps, lr=lr, weight_decay=plan["weight_decay"])}[case["opt"]]
        if case["kind"] == "scan":
            fns = ((gpt_embed, gpt_layer, gpt_head) if case["model"] == "gpt"
                   else (embed, layer, head))
            init, make_step = FS.make_fsdp_scan_step(*fns, make_opt,
                                                     remat=case["remat"])
        else:
            loss = stack_loss if case["model"] == "stack" else linear_loss
            maker = (FS.make_fsdp_step if case["kind"] == "flat"
                     else FS.make_zero1_step)
            init, make_step = maker(loss, make_opt)
        refs = [weakref.ref(t) for t in tree_leaves(params)]
        shards, opt, meta = init(params)
        del params
        gc.collect()
        res[f"{name}/inputs_alive"] = np.array(
            sum(r() is not None for r in refs))
        step = make_step(meta)
        saved = (FS._mean, C._gather_tiled)
        if case["fault"] == "no_mean":
            FS._mean = lambda grads, n: list(grads)
        elif case["fault"] == "reversed":
            C._gather_tiled = reversed_gather(C._gather_tiled)
        FS.reset_gathered()
        try:
            res[f"{name}/loss"] = np.array(
                [float(step(shards, opt, batch)) for _ in range(case["steps"])])
        finally:
            FS._mean, C._gather_tiled = saved
        res[f"{name}/gathered_peak"] = np.array(FS.gathered["peak"])
        res[f"{name}/gathered_live"] = np.array(FS.gathered["live"])
        state = shards if isinstance(shards, dict) else {"flat": shards}
        res.update(named(state, f"{name}/p"))
        p = meta.shard if case["kind"] == "zero1" else tree_leaves(shards)[0]
        for k, v in opt.state[p].items():
            res[f"{name}/opt/{k}"] = v.detach().numpy()
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of the port, from four gloo ranks spawned once: one npz
    of results per rank."""
    tmp = tmp_path_factory.mktemp("fsdp")
    _EXAMPLE.append(subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.examples.fsdp_zero",
         "--device", "cpu", "--world", "2", "--steps", "10"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    flat, inputs = {}, {}
    for name, case in CASES.items():
        key = f"{case['model']}_{case['L']}"
        inputs[name] = key
        if f"in/{key}/batch/0" in flat:
            continue
        params, batch = _inputs(case)
        flat.update(_flatten(params, f"in/{key}/params/"))
        flat[f"in/{key}/batch/0"], flat[f"in/{key}/batch/1"] = batch
    np.savez(tmp / "in.npz", **flat)
    plan = {"cases": CASES, "inputs": inputs, "gpt": GPT,
            "chunk": GPT_CHUNK, "weight_decay": WEIGHT_DECAY}
    (tmp / "plan.json").write_text(json.dumps(plan))
    i, code = launch(
        [[sys.executable, "-c", WORKER, str(r), str(WORLD), str(tmp)]
         for r in range(WORLD)],
        dict(os.environ, PYTHONPATH=str(REPO)), REPO, 300, tmp)
    assert i is None, (code, (tmp / f"{i}.log").read_text())
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]


# ----------------------------------------------------------- JAX's side
def _jax_models(case):
    """JAX's loss (flat kinds) or scan-contract functions (scan kind)."""
    if case["model"] == "gpt":
        cfg = _jcfg()

        def embed(ep, batch):
            T = batch[0].shape[1]
            return JG.embed(ep, batch[0], jnp.arange(T)[None], cfg)

        def layer(lp, x):
            return JG.apply_layer(lp, x, cfg, attn="dense")

        def head(hp, x, batch):
            x = JG.rms_norm(x, hp["lnf"])
            return jax_chunked_ce(x, hp["lm_head"], batch[1],
                                  GPT_CHUNK).mean()
        return embed, layer, head

    def embed(ep, batch):
        return jnp.tanh(batch[0] @ ep["w_in"])

    def layer(lp, act):
        return act + jnp.tanh(act @ lp["w"] + lp["b"])

    def head(hp, act, batch):
        return jnp.mean((act @ hp["w_out"] - batch[1]) ** 2)

    if case["kind"] == "scan":
        return embed, layer, head

    def linear_loss(p, batch):
        pred = batch[0] @ p["w"] + (p["b"] if "b" in p else 0.0)
        return jnp.mean((pred - batch[1]) ** 2)
    return linear_loss


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """JAX's step on a WORLD-device mesh: (losses, the flat state as
    padded global arrays by name, the optimizer state's leaves)."""
    case = CASES[name]
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("fsdp",))
    opt = {"sgd": optax.sgd, "adam": optax.adam,
           "adamw": functools.partial(optax.adamw,
                                      weight_decay=WEIGHT_DECAY)}[
        case["opt"]](case["lr"])
    params, batch = _inputs(case)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    batch = tuple(jnp.asarray(b) for b in batch)
    if case["kind"] == "scan":
        init, make_step = make_fsdp_scan_step(*_jax_models(case), opt, mesh,
                                              remat=case["remat"])
    else:
        maker = make_fsdp_step if case["kind"] == "flat" else make_zero1_step
        init, make_step = maker(_jax_models(case), opt, mesh)
    state, opt_state, meta = init(params)
    step = make_step(meta)
    losses = []
    for _ in range(case["steps"]):
        state, opt_state, loss = step(state, opt_state, batch)
        losses.append(float(np.asarray(loss)))
    state = state if isinstance(state, dict) else {"flat": state}
    return (np.array(losses), {k: np.asarray(v) for k, v in state.items()},
            [np.asarray(x) for x in jax.tree_util.tree_leaves(opt_state)])


def _chunk(arr, r, n=WORLD):
    return np.split(arr, n, axis=-1)[r]


def _compare(ranks, name, want_name=None, loss_rtol=LOSS_RTOL, tol=TOL):
    """Each rank's losses and chunks against JAX's run of ``want_name``
    (default: the case itself)."""
    case = CASES[name]
    losses, state, _ = jax_run(want_name or name)
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"{name}/loss"], losses,
                                   rtol=loss_rtol, err_msg=f"rank {r}")
        for key, want in state.items():
            if case["kind"] != "zero1":
                want = _chunk(want, r)
            np.testing.assert_allclose(ranks[r][f"{name}/p/{key}"], want,
                                       **tol, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("name", ["fsdp_sgd", "fsdp_adam_scalar",
                                  "zero1_adam", "fsdp_adamw_padded",
                                  "scan_trajectory",
                                  "gpt_adam", "gpt_sgd"])
def test_matches_jax(ranks, name):
    if name == "scan_trajectory":
        _compare(ranks, name, **ADAM_LR05)
    elif name == "gpt_adam":
        _compare(ranks, name, **ADAM)
    else:
        _compare(ranks, name)


def test_scan_matches_one_process(ranks):
    """tests/test_fsdp_scan.py:86's oracle in the port: the same model,
    data and Adam in one process with nothing sharded."""
    import torch
    params, (x, y) = _stack_inputs(4)
    p = {k: {kk: torch.tensor(vv, requires_grad=True)
             for kk, vv in v.items()} for k, v in params.items()}
    opt = torch.optim.Adam([t for v in p.values() for t in v.values()],
                           lr=CASES["scan_trajectory"]["lr"])
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(CASES["scan_trajectory"]["steps"]):
        a = torch.tanh(x @ p["embed"]["w_in"])
        for i in range(4):
            a = a + torch.tanh(a @ p["layers"]["w"][i] + p["layers"]["b"][i])
        loss = ((a @ p["head"]["w_out"] - y) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    layers = torch.cat([p["layers"]["b"], p["layers"]["w"].flatten(1)],
                       dim=1).detach().numpy()
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["scan_trajectory/loss"], losses,
                                   rtol=LOSS_RTOL)
        # tests/test_fsdp_scan.py's limit for the layers against its oracle
        np.testing.assert_allclose(ranks[r]["scan_trajectory/p/layers"]
                                   [:, :_chunk(layers, r).shape[1]],
                                   _chunk(layers, r), atol=2e-5)


def test_fsdp_adam_state_is_sharded_with_a_replicated_step(ranks):
    """Adam's moments are the rank's chunk (1/n); its step count is a
    scalar, the same on every rank (tests/test_parallel.py:101)."""
    _, state, leaves = jax_run("fsdp_adam_scalar")
    local = state["flat"].shape[0] // WORLD
    mu, nu = [x for x in leaves if x.ndim == 1]
    for r in range(WORLD):
        assert ranks[r]["fsdp_adam_scalar/opt/step"].shape == ()
        assert float(ranks[r]["fsdp_adam_scalar/opt/step"]) == 2
        for k, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
            got = ranks[r][f"fsdp_adam_scalar/opt/{k}"]
            assert got.shape == (local,)
            np.testing.assert_allclose(got, _chunk(want, r), rtol=1e-5,
                                       atol=1e-7)


def test_zero1_replicas_agree_and_state_is_sharded(ranks):
    _, state, _ = jax_run("zero1_adam")
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["zero1_adam/p/flat"],
                                      ranks[0]["zero1_adam/p/flat"])
        assert ranks[r]["zero1_adam/opt/exp_avg"].shape == (
            state["flat"].shape[0] // WORLD,)


def test_scan_without_remat_matches_remat(ranks):
    """tests/test_fsdp_scan.py:189: remat changes nothing, in the port and
    against JAX's step without it."""
    _compare(ranks, "scan_no_remat")
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["scan_no_remat/loss"],
                                   ranks[r]["scan_remat/loss"], rtol=1e-6)
        np.testing.assert_allclose(ranks[r]["scan_no_remat/p/layers"],
                                   ranks[r]["scan_remat/p/layers"],
                                   atol=1e-6)


def test_padding_stays_zero(ranks):
    """33 parameters over 4 ranks: the last chunk's 3 padded entries stay
    zero under AdamW (decay included) and ZeRO-1's Adam."""
    for name, key in (("fsdp_adamw_padded", "p/flat"),
                      ("zero1_adam", "p/flat")):
        got = ranks[WORLD - 1][f"{name}/{key}"]
        np.testing.assert_array_equal(got[-3:], 0.0, err_msg=name)
    assert ranks[WORLD - 1]["fsdp_adamw_padded/p/flat"].shape == (9,)


def _layer_bytes():
    return 4 * (D_MODEL * D_MODEL + D_MODEL)


@pytest.mark.parametrize("name", ["fsdp_sgd", "zero1_adam",
                                  "scan_trajectory", "gpt_sgd"])
def test_init_keeps_no_reference_to_the_input_tree(ranks, name):
    """After ``init`` the caller's parameter tree dies with its last
    reference: no meta keeps a leaf (or a view of one) alive, so a rank
    holds only its chunks, not a full unsharded copy of the model."""
    for r in range(WORLD):
        assert int(ranks[r][f"{name}/inputs_alive"]) == 0, r


def test_scan_gathers_one_layer_not_the_full_parameters(ranks):
    """tests/test_fsdp_scan.py:117 as gathered bytes alive at once: the
    scan step holds one layer's copy (with the embedding and head), the
    monolithic step the full parameters."""
    L = 16
    full = L * _layer_bytes()
    for r in range(WORLD):
        scan = int(ranks[r]["mem_scan_16/gathered_peak"])
        flat = int(ranks[r]["mem_flat_16/gathered_peak"])
        assert flat >= full, (flat, full)
        # one padded layer, the embedding (16 x 64) and the head (64 x 4)
        assert scan <= _layer_bytes() + 4 * (16 * 64 + 64 * 4) + 64, scan
        assert scan < flat / 8, (scan, flat)
        assert int(ranks[r]["mem_scan_16/gathered_live"]) == 0


def test_gathered_bytes_do_not_grow_with_depth(ranks):
    """tests/test_fsdp_scan.py:161: 24 more layers add less than two
    layers' parameter bytes to the gathered copy alive at once."""
    for r in range(WORLD):
        growth = (int(ranks[r]["mem_scan_32/gathered_peak"])
                  - int(ranks[r]["mem_scan_8/gathered_peak"]))
        assert growth < 2 * _layer_bytes(), growth


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_comparison(ranks, fault):
    with pytest.raises(AssertionError):
        _compare(ranks, fault, FAULTS[fault])
    _, state, _ = jax_run(FAULTS[fault])
    gap = max(float(np.abs(ranks[r][f"{fault}/p/{k}"] - _chunk(v, r)).max())
              for r in range(WORLD) for k, v in state.items())
    assert gap > 100 * TOL["atol"], gap


def test_example_runs_on_the_cpu(ranks):
    """``python -m kungfu_tpu_torch.examples.fsdp_zero --device cpu``
    (started beside the ranks): ZeRO-3 and ZeRO-1 at 2 ranks, each loss
    curve falls and the two agree."""
    proc = _EXAMPLE[0]
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    lines = [ln for ln in out.splitlines() if "loss" in ln]
    assert len(lines) == 2, out
    curves = [[float(x) for x in ln.split("loss ")[1].split()[0:3:2]]
              for ln in lines]
    for first, last in curves:
        assert last < first, curves
    np.testing.assert_allclose(curves[0], curves[1], rtol=1e-5)
