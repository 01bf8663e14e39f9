"""The port's dp x sp x tp GPT step against JAX's.

Eight gloo ranks, spawned once for the module, run
``kungfu_tpu_torch.parallel.threed.make_gpt_train_step`` on every case of
tests/test_gpt3d.py's parity matrix, from the JAX init converted with
``convert.params_from_jax`` and sliced by ``shard_params``; the test side
runs ``kungfu_tpu.parallel.threed.make_gpt_train_step`` on the same mesh
shape over the conftest's virtual devices.  Each rank's loss and
post-step parameter shards must equal JAX's (SGD: Adam would hide a
uniform gradient scale).  Also: remat, a RoPE + SwiGLU + GQA model, the
Adam loss curve, the vocab-sharded cross-entropy and its gradient, and
four planted faults (no future mask in the ring-flash merge, replicated
gradients summed over tp once more, RoPE without the sp offset, Ulysses'
all-to-all concatenating its blocks in reverse rank order), each of
which must fail the comparison.  A 4-rank mesh runs on ranks 0-3; the
others only take part in forming its groups.
"""
import functools
import json
import os
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.models import gpt as JG
from kungfu_tpu.parallel import threed as JT3
from kungfu_tpu_torch.examples.ranks import launch
from kungfu_tpu_torch.models import gpt as G

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
CFGS = {
    "base": dict(vocab_size=64, d_model=16, n_heads=4, n_layers=2, d_ff=32,
                 max_seq=32),
    "rope": dict(vocab_size=64, d_model=16, n_heads=4, n_kv_heads=2,
                 n_layers=2, d_ff=32, max_seq=32, rope=True, mlp="swiglu"),
}
# tests/test_gpt3d.py's limits for its parity against one device
LOSS_RTOL = 1e-4
TOL = {"rtol": 2e-4, "atol": 2e-5}
DATA = {"batch": 4, "seq": 8, "seed": 0}


def _case(mesh, attn, cfg="base", opt="sgd", lr=0.1, steps=1, remat=False,
          fault=None, data=DATA, seed=0):
    return {"mesh": list(mesh), "attn": attn, "cfg": cfg, "opt": opt,
            "lr": lr, "steps": steps, "remat": remat, "fault": fault,
            "data": data, "seed": seed}


PARITY = [(2, 2, 2, "ring"), (2, 2, 2, "ring_flash"), (2, 2, 2, "ulysses"),
          (1, 1, 4, "dense"), (4, 1, 1, "dense"), (1, 4, 1, "ring"),
          (1, 4, 1, "ring_flash")]
CASES = {f"{dp}{sp}{tp}_{attn}": _case((dp, sp, tp), attn)
         for dp, sp, tp, attn in PARITY}
CASES.update({
    "rope_222_ring_flash": _case((2, 2, 2), "ring_flash", cfg="rope"),
    "rope_141_ring": _case((1, 4, 1), "ring", cfg="rope"),
    "remat_222_ring": _case((2, 2, 2), "ring", remat=True),
    "adam_222_auto": _case((2, 2, 2), "auto", opt="adam", lr=1e-2, steps=8,
                           data={"batch": 8, "seq": 16, "seed": 1}, seed=1),
})
# planted faults: the case they corrupt
FAULTS = {"no_future_mask": "141_ring_flash",
          "tp_twice": "222_ring",
          "rope_no_offset": "rope_141_ring",
          "a2a_reversed": "222_ulysses"}
for _f, _c in FAULTS.items():
    CASES[_f] = dict(CASES[_c], fault=_f)


def _data(cfg, batch, seq, seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg["vocab_size"], (batch, seq)).astype(np.int32)
    targets = rng.randint(0, cfg["vocab_size"], (batch, seq)).astype(np.int32)
    return tokens, targets


def _jcfg(name):
    return JG.GPTConfig(**CFGS[name], dtype=jnp.float32)


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
    import importlib, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import convert
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.models import gpt as G
    from kungfu_tpu_torch.parallel import threed as T3
    from kungfu_tpu_torch.utils.tree import tree_leaves

    # the module (the package exports its function of the same name)
    RA = importlib.import_module("kungfu_tpu_torch.parallel.ring_attention")
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    init_process_group_file(f"{tmp}/store", rank, world, "gloo",
                            timeout_s=120)
    plan = json.load(open(f"{tmp}/plan.json"))
    flat = dict(np.load(f"{tmp}/in.npz"))
    meshes = {tuple(m): T3.mesh_3d(*m, timeout_s=120)
              for m in plan["meshes"]}

    def unflatten(prefix):
        tree = {}
        for key, v in flat.items():
            if not key.startswith(prefix + "/"):
                continue
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        if "layers" in tree:
            tree["layers"] = [tree["layers"][str(i)]
                              for i in range(len(tree["layers"]))]
        return tree

    def named(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree)
                    for x in named(tree[k], f"{prefix}{k}/")]
        if isinstance(tree, list):
            return [x for i, t in enumerate(tree)
                    for x in named(t, f"{prefix}{i}/")]
        return [(prefix[:-1], tree)]

    def tp_twice(orig):
        def sync(masters, mesh):
            orig(masters, mesh)
            specs = tree_leaves(G.param_specs(cfg))
            for m, dim in zip(masters, specs):
                if dim is None:
                    dist.all_reduce(m.grad, group=mesh.group("tp"))
        return sync

    def a2a_reversed(orig):
        def run(x, group, split_axis, concat_axis):
            y = orig(x, group, split_axis, concat_axis)
            n = dist.get_world_size(group)
            return torch.cat(y.chunk(n, concat_axis)[::-1], concat_axis)
        return run

    res = {}
    for name, case in plan["cases"].items():
        mesh = meshes[tuple(case["mesh"])]
        if mesh is None:
            continue
        cfg = G.GPTConfig(**plan["cfgs"][case["cfg"]], dtype=torch.float32)
        params = T3.shard_params(
            convert.params_from_jax(unflatten(f"{case['cfg']}/{case['seed']}"),
                                    cfg), cfg, mesh)
        leaves = tree_leaves(params)
        opt = (torch.optim.SGD(leaves, lr=case["lr"]) if case["opt"] == "sgd"
               else torch.optim.Adam(leaves, lr=case["lr"]))
        saved = (RA._is_future, T3._sync_gradients, G._global_positions,
                 C._all_to_all)
        if case["fault"] == "no_future_mask":
            RA._is_future = lambda src, rank: False
        elif case["fault"] == "tp_twice":
            T3._sync_gradients = tp_twice(T3._sync_gradients)
        elif case["fault"] == "rope_no_offset":
            G._global_positions = lambda T, g, dev: torch.arange(T,
                                                                 device=dev)
        elif case["fault"] == "a2a_reversed":
            C._all_to_all = a2a_reversed(C._all_to_all)
        step = T3.make_gpt_train_step(cfg, opt, mesh, params,
                                      attn=case["attn"], remat=case["remat"])
        d = case["data"]
        tok = torch.from_numpy(flat[f"data/{d['batch']}_{d['seq']}_{d['seed']}/tokens"])
        tgt = torch.from_numpy(flat[f"data/{d['batch']}_{d['seq']}_{d['seed']}/targets"])
        res[f"{name}/loss"] = np.array(
            [float(step(tok, tgt)) for _ in range(case["steps"])])
        (RA._is_future, T3._sync_gradients, G._global_positions,
         C._all_to_all) = saved
        for key, t in named(params):
            res[f"{name}/p/{key}"] = t.detach().numpy()

    mesh = meshes[(1, 1, 4)]
    if mesh is not None:
        logits = torch.from_numpy(flat["ce/logits"])
        local = logits.chunk(4, dim=-1)[mesh.index("tp")].clone()
        local.requires_grad_()
        nll = G.parallel_cross_entropy(local, torch.from_numpy(
            flat["ce/targets"]), mesh.group("tp"))
        nll.sum().backward()
        res["ce/nll"], res["ce/grad"] = nll.detach().numpy(), local.grad.numpy()
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")


def _ce_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(4, 8, 64).astype(np.float32),
            rng.randint(0, 64, (4, 8)).astype(np.int32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of the port, from eight gloo ranks spawned once: one
    npz of results per rank."""
    tmp = tmp_path_factory.mktemp("gpt3d")
    flat = {}
    for case in CASES.values():
        key = f"{case['cfg']}/{case['seed']}"
        if not any(k.startswith(key + "/") for k in flat):
            tree = JG.init_params(jax.random.PRNGKey(case["seed"]),
                                  _jcfg(case["cfg"]))
            flat.update(_flatten(tree, key + "/"))
        d = case["data"]
        tok, tgt = _data(CFGS[case["cfg"]], d["batch"], d["seq"], d["seed"])
        dk = f"data/{d['batch']}_{d['seq']}_{d['seed']}"
        flat[f"{dk}/tokens"], flat[f"{dk}/targets"] = tok, tgt
    flat["ce/logits"], flat["ce/targets"] = _ce_inputs()
    np.savez(tmp / "in.npz", **flat)
    meshes = sorted({tuple(c["mesh"]) for c in CASES.values()} | {(1, 1, 4)})
    plan = {"cases": CASES, "cfgs": CFGS, "meshes": meshes}
    (tmp / "plan.json").write_text(json.dumps(plan))
    i, code = launch(
        [[sys.executable, "-c", WORKER, str(r), str(WORLD), str(tmp)]
         for r in range(WORLD)],
        dict(os.environ, PYTHONPATH=str(REPO)), REPO, 400, tmp)
    assert i is None, (code, (tmp / f"{i}.log").read_text())
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """JAX's 3D step on the case's mesh: (losses, full post-step params
    flattened by key)."""
    case = CASES[name]
    cfg = _jcfg(case["cfg"])
    opt = (optax.sgd(case["lr"]) if case["opt"] == "sgd"
           else optax.adam(case["lr"]))
    mesh = JT3.mesh_3d(*case["mesh"], jax.devices())
    params, state = JT3.init_gpt(cfg, opt, mesh, seed=case["seed"])
    step = JT3.make_gpt_train_step(cfg, opt, mesh, attn=case["attn"],
                                   donate=False, remat=case["remat"])
    d = case["data"]
    tokens, targets = (jnp.asarray(a) for a in _data(
        CFGS[case["cfg"]], d["batch"], d["seq"], d["seed"]))
    losses = []
    for _ in range(case["steps"]):
        params, state, loss = step(params, state, tokens, targets)
        losses.append(float(loss))
    return np.array(losses), _flatten(jax.device_get(params))


def _tp_dims(cfg_name):
    """key -> the dimension JAX's param_specs shards over tp (or None)."""
    specs = JG.param_specs(_jcfg(cfg_name), "tp")
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        elif isinstance(node, list):
            for i, t in enumerate(node):
                walk(t, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = (list(node).index("tp") if "tp" in node
                                 else None)
    walk(specs, "")
    return flat


def _compare(ranks, name, want_name=None, loss_rtol=LOSS_RTOL, tol=TOL):
    """Each rank's losses and parameter shards against JAX's run of
    ``want_name`` (default: the case itself)."""
    case = CASES[name]
    losses, params = jax_run(want_name or name)
    dp, sp, tp = case["mesh"]
    dims = _tp_dims(case["cfg"])
    for r in range(dp * sp * tp):
        np.testing.assert_allclose(ranks[r][f"{name}/loss"], losses,
                                   rtol=loss_rtol)
        for key, want in params.items():
            if dims[key] is not None:
                want = np.split(want, tp, axis=dims[key])[r % tp]
            np.testing.assert_allclose(ranks[r][f"{name}/p/{key}"], want,
                                       **tol, err_msg=f"rank {r} {key}")


def _gap(ranks, name, want_name):
    """The largest |port - JAX| over the case's ranks and parameters."""
    case = CASES[name]
    _, params = jax_run(want_name)
    dp, sp, tp = case["mesh"]
    dims = _tp_dims(case["cfg"])
    gap = 0.0
    for r in range(dp * sp * tp):
        for key, want in params.items():
            if dims[key] is not None:
                want = np.split(want, tp, axis=dims[key])[r % tp]
            gap = max(gap, float(np.abs(ranks[r][f"{name}/p/{key}"]
                                        - want).max()))
    return gap


@pytest.mark.parametrize("name", list(CASES)[:len(PARITY)] + [
    "rope_222_ring_flash", "rope_141_ring"])
def test_parity_with_jax(ranks, name):
    _compare(ranks, name)


def test_remat_matches_no_remat(ranks):
    """Per-layer remat changes neither the loss nor the step, against JAX
    and against the port's own run without it."""
    _compare(ranks, "remat_222_ring", "222_ring")
    for r in range(WORLD):
        for key in ranks[r]:
            if key.startswith("remat_222_ring/"):
                np.testing.assert_allclose(
                    ranks[r][key],
                    ranks[r][key.replace("remat_222_ring", "222_ring")],
                    rtol=1e-5, atol=1e-6)


def test_loss_decreases_3d_as_in_jax(ranks):
    want, _ = jax_run("adam_222_auto")
    for r in range(WORLD):
        got = ranks[r]["adam_222_auto/loss"]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert got[-1] < got[0] * 0.9, got


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_comparison(ranks, fault):
    with pytest.raises(AssertionError):
        _compare(ranks, fault, FAULTS[fault])
    gap = _gap(ranks, fault, FAULTS[fault])
    assert gap > 100 * TOL["atol"], gap


def test_parallel_cross_entropy_matches_optax(ranks):
    logits, targets = _ce_inputs()
    ours = G.parallel_cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(targets))
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # vocab-sharded over four tp ranks: the same values, and each rank's
    # slice of the gradient
    grad = np.asarray(jax.grad(lambda x: optax.softmax_cross_entropy_with_integer_labels(
        x, jnp.asarray(targets)).sum())(jnp.asarray(logits)))
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["ce/nll"], np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ranks[r]["ce/grad"],
                                   np.split(grad, 4, axis=-1)[r],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", list(CFGS))
def test_param_specs_match_jax(cfg):
    tree = G.param_specs(G.GPTConfig(**CFGS[cfg]))
    assert {k: v.item() for k, v in _flatten(tree).items()} == _tp_dims(cfg)


@pytest.mark.parametrize("ntp", [1, 2, 3, 4, 8])
def test_validate_tp_as_jax(ntp):
    for cfg in CFGS:
        def outcome(fn, c):
            try:
                fn(c, ntp)
                return None
            except ValueError as e:
                return str(e)
        assert (outcome(G.validate_tp, G.GPTConfig(**CFGS[cfg]))
                == outcome(JG.validate_tp, _jcfg(cfg)))
    with pytest.raises(ValueError):
        G.validate_tp(G.GPTConfig(**CFGS["base"]), 3)


def test_vocab_constraints():
    with pytest.raises(ValueError):
        G.GPTConfig(d_model=10, n_heads=3)


def test_example_trains_on_the_cpu():
    """``python -m kungfu_tpu_torch.examples.gpt_3d_parallel --device
    cpu``: 8 ranks (2 x 2 x 2), the loss falls."""
    import subprocess
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.examples.gpt_3d_parallel",
         "--device", "cpu", "--steps", "3"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    losses = [float(line.split("loss=")[1]) for line in r.stdout.splitlines()
              if "loss=" in line]
    assert len(losses) == 3 and np.all(np.isfinite(losses)), r.stdout
    assert losses[-1] < losses[0], losses
