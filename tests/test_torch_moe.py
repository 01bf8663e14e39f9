"""The port's expert parallelism (switch-MoE and the MoE-GPT) against JAX's.

One process: ``moe_ffn`` with every expert local against JAX's at
capacity 0.25, 1.25 and 8.0 (outputs, aux loss, gradients), the MoE-GPT
tree's structure and its conversion.  Eight gloo ranks, spawned once for
the module, run ``make_moe_step`` and the MoE-GPT ``make_train_step`` at
(dp, ep) = (2, 4), (1, 8) and (4, 2), at capacity 8.0 with no aux loss
and at capacity 1.25 with aux 0.01, from JAX's init carried across; the
test side runs JAX's sharded steps on the same mesh shape over the
conftest's virtual devices, so the drops and the aux loss's gradient are
held to JAX's too.  Each rank's loss and post-step shards must equal
JAX's (SGD).  Also: the Adam loss curves, the "not divisible" raise, the
example, and three planted faults (the all-to-all joining its blocks in
reverse rank order, the experts' gradients summed over ep too, the
overflowed tokens dropped from the residual), each of which must fail
the comparison.
"""
import json
import os
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.models import gpt as JG
from kungfu_tpu.parallel import moe as JM
from kungfu_tpu.parallel import moe_gpt as JMG
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.examples.ranks import launch
from kungfu_tpu_torch.models import gpt as G
from kungfu_tpu_torch.parallel import moe as M
from kungfu_tpu_torch.parallel import moe_gpt as MG

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
GPT = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=4, d_ff=32,
           max_seq=32)
LOSS_RTOL = 1e-4
TOL = {"rtol": 2e-4, "atol": 2e-5}
SETTINGS = {"nodrop": (8.0, 0.0), "drop": (1.25, 0.01)}


def _case(kind, mesh, setting=None, experts=8, cap=None, aux=None,
          opt="sgd", lr=0.1, steps=1, data=None, seed=0, fault=None):
    if setting is not None:
        cap, aux = SETTINGS[setting]
    if data is None:
        data = (8, 4, 0) if kind == "ffn" else (8, 8, 0)
    return {"kind": kind, "mesh": list(mesh), "experts": experts,
            "cap": cap, "aux": aux, "opt": opt, "lr": lr, "steps": steps,
            "data": list(data), "seed": seed, "fault": fault}


MESHES = [(2, 4), (1, 8), (4, 2)]
CASES = {f"{kind}_{dp}{ep}_{s}": _case(kind, (dp, ep), s)
         for kind in ("ffn", "gpt") for dp, ep in MESHES
         for s in SETTINGS}
PARITY = list(CASES)
CASES.update({
    "ffn_adam": _case("ffn", (2, 4), experts=4, cap=2.0, aux=0.01,
                      opt="adam", lr=1e-2, steps=10, data=(16, 4, 1),
                      seed=1),
    "gpt_adam": _case("gpt", (2, 4), experts=4, cap=2.0, aux=0.01,
                      opt="adam", lr=1e-2, steps=8, data=(16, 16, 1),
                      seed=1),
})
FAULTS = {"a2a_reversed": "ffn_24_nodrop",
          "experts_over_ep": "gpt_42_nodrop",
          "overflow_dropped": "gpt_24_drop"}
for _f, _c in FAULTS.items():
    CASES[_f] = dict(CASES[_c], fault=_f)


def _ffn_cfg(case, dtype=jnp.float32):
    return JM.MoEConfig(d_model=16, d_ff=32, n_experts=case["experts"],
                        capacity_factor=case["cap"], dtype=dtype)


def _gpt_cfg(case):
    return JMG.MoEGPTConfig(
        gpt=JG.GPTConfig(**GPT, dtype=jnp.float32),
        n_experts=case["experts"], expert_every=2,
        capacity_factor=case["cap"], aux_weight=case["aux"])


def _data(case):
    b, t, seed = case["data"]
    rng = np.random.RandomState(seed)
    if case["kind"] == "ffn":
        return (rng.randn(b, t, 16).astype(np.float32),
                rng.randn(b, t, 16).astype(np.float32))
    V = GPT["vocab_size"]
    return (rng.randint(0, V, (b, t)).astype(np.int32),
            rng.randint(0, V, (b, t)).astype(np.int32))


def _init(case):
    key = jax.random.PRNGKey(case["seed"])
    if case["kind"] == "ffn":
        return JM.init_moe_params(key, _ffn_cfg(case))
    return JMG.init_params(key, _gpt_cfg(case))


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


def jax_run(name):
    """JAX's sharded step on the case's mesh: (losses, the full post-step
    tree flattened by key)."""
    case = CASES[name]
    opt = (optax.sgd(case["lr"]) if case["opt"] == "sgd"
           else optax.adam(case["lr"]))
    params = _init(case)
    if case["kind"] == "ffn":
        mesh = JM.mesh_dp_ep(*case["mesh"], jax.devices())
        step = JM.make_moe_step(_ffn_cfg(case), opt, mesh,
                                aux_weight=case["aux"], donate=False)
        state = jax.jit(opt.init)(params)
    else:
        mesh = JMG.mesh_dp_ep(*case["mesh"], jax.devices())
        params, state = JMG.init_moe_gpt(_gpt_cfg(case), opt, mesh,
                                         seed=case["seed"])
        step = JMG.make_train_step(_gpt_cfg(case), opt, mesh, donate=False)
    a, b = (jnp.asarray(t) for t in _data(case))
    losses = []
    for _ in range(case["steps"]):
        params, state, loss = step(params, state, a, b)
        losses.append(float(loss))
    return np.array(losses), _flatten(jax.device_get(params))




WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import convert
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.models import gpt as G
    from kungfu_tpu_torch.parallel import moe as M
    from kungfu_tpu_torch.parallel import moe_gpt as MG
    from kungfu_tpu_torch.utils.tree import tree_leaves

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    init_process_group_file(f"{tmp}/store", rank, world, "gloo",
                            timeout_s=120)
    plan = json.load(open(f"{tmp}/plan.json"))
    flat = dict(np.load(f"{tmp}/in.npz"))
    meshes = {tuple(m): M.mesh_dp_ep(*m, timeout_s=120)
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

    def a2a_reversed(orig):
        def run(x, group, split_axis, concat_axis):
            y = orig(x, group, split_axis, concat_axis)
            n = dist.get_world_size(group)
            return torch.cat(y.chunk(n, concat_axis)[::-1], concat_axis)
        return run

    def experts_over_ep(orig):
        def sync(masters, expert_leaf, mesh):
            orig(masters, expert_leaf, mesh)
            for m, e in zip(masters, expert_leaf):
                if e:
                    dist.all_reduce(m.grad, group=mesh.group("ep"))
        return sync

    def overflow_dropped(route, apply_layer):
        kept = []

        def rt(*args):
            out = route(*args)
            kept.append(out[2])
            return out

        def layer(layer, x, cfg, **kw):
            y = apply_layer(layer, x, cfg, **kw)
            if kw.get("ffn") is not None:
                y = y * kept.pop().reshape(y.shape[:2])[..., None]
            return y
        return rt, layer

    res = {}
    for name, case in plan["cases"].items():
        mesh = meshes[tuple(case["mesh"])]
        if mesh is None:
            continue
        saved = (C._all_to_all, M._sync_gradients, M._route, G.apply_layer)
        if case["fault"] == "a2a_reversed":
            C._all_to_all = a2a_reversed(C._all_to_all)
        elif case["fault"] == "experts_over_ep":
            M._sync_gradients = experts_over_ep(M._sync_gradients)
        elif case["fault"] == "overflow_dropped":
            M._route, G.apply_layer = overflow_dropped(M._route,
                                                       G.apply_layer)
        tree = unflatten(f"init/{case['kind']}/{case['experts']}/"
                         f"{case['seed']}")
        b, t, sd = case["data"]
        d = f"data/{case['kind']}/{b}_{t}_{sd}"
        a, y = (torch.from_numpy(flat[f"{d}/{k}"]) for k in ("a", "b"))
        if case["kind"] == "ffn":
            cfg = M.MoEConfig(d_model=16, d_ff=32,
                              n_experts=case["experts"],
                              capacity_factor=case["cap"],
                              dtype=torch.float32)
            params = M.shard_moe_params(
                {k: torch.from_numpy(v) for k, v in tree.items()}, mesh)
        else:
            cfg = MG.MoEGPTConfig(
                gpt=G.GPTConfig(**plan["gpt"], dtype=torch.float32),
                n_experts=case["experts"], expert_every=2,
                capacity_factor=case["cap"], aux_weight=case["aux"])
            params = MG.shard_params(convert.params_from_jax(tree, cfg),
                                     cfg, mesh)
        leaves = tree_leaves(params)
        opt = (torch.optim.SGD(leaves, lr=case["lr"]) if case["opt"] == "sgd"
               else torch.optim.Adam(leaves, lr=case["lr"]))
        if case["kind"] == "ffn":
            step = M.make_moe_step(cfg, opt, mesh, params,
                                   aux_weight=case["aux"])
        else:
            step = MG.make_train_step(cfg, opt, mesh, params)
        res[f"{name}/loss"] = np.array(
            [float(step(a, y)) for _ in range(case["steps"])])
        (C._all_to_all, M._sync_gradients, M._route, G.apply_layer) = saved
        for key, t in named(params):
            res[f"{name}/p/{key}"] = t.detach().numpy()
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")

EXAMPLE = {}


def _example():
    """``python -m kungfu_tpu_torch.examples.moe_gpt_expert_parallel
    --device cpu`` at (1, 2), 3 steps: (exit code, losses, stderr)."""
    import subprocess
    r = subprocess.run(
        [sys.executable, "-m",
         "kungfu_tpu_torch.examples.moe_gpt_expert_parallel",
         "--device", "cpu", "--dp", "1", "--ep", "2", "--steps", "3"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    losses = [float(line.split("loss=")[1]) for line in r.stdout.splitlines()
              if "loss=" in line]
    return r.returncode, losses, r.stderr[-3000:]


JAX = {}      # name -> JAX's (losses, params), filled by the fixture
# the Adam curves are held to JAX's tests' bars, not run by JAX here
JAX_RUNS = [n for n, c in CASES.items()
            if c["fault"] is None and c["opt"] == "sgd"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of the port, from eight gloo ranks spawned once (one
    npz of results per rank); JAX's runs (into ``JAX``) and the
    example's meanwhile."""
    tmp = tmp_path_factory.mktemp("moe")
    flat = {}
    for case in CASES.values():
        key = f"init/{case['kind']}/{case['experts']}/{case['seed']}"
        if not any(k.startswith(key + "/") for k in flat):
            flat.update(_flatten(_init(case), key + "/"))
        b, t, sd = case["data"]
        d = f"data/{case['kind']}/{b}_{t}_{sd}"
        flat[f"{d}/a"], flat[f"{d}/b"] = _data(case)
    np.savez(tmp / "in.npz", **flat)
    plan = {"cases": CASES, "gpt": GPT, "meshes": MESHES}
    (tmp / "plan.json").write_text(json.dumps(plan))
    with ThreadPoolExecutor(2) as pool:
        job = pool.submit(launch, [
            [sys.executable, "-c", WORKER, str(r), str(WORLD), str(tmp)]
            for r in range(WORLD)],
            dict(os.environ, PYTHONPATH=str(REPO)), REPO, 300, tmp)
        ex = pool.submit(_example)
        for name in JAX_RUNS:
            JAX[name] = jax_run(name)
        i, code = job.result()
        EXAMPLE["run"] = ex.result()
    assert i is None, (code, (tmp / f"{i}.log").read_text())
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]


def _block(case, r, key, want):
    """Rank r's shard of the full leaf ``key``: its experts' block."""
    dp, ep = case["mesh"]
    if key.split("/")[-1] in ("wi", "wo") and (
            case["kind"] == "ffn" or "/moe/" in key):
        return np.split(want, ep, axis=0)[r % ep]
    return want


def _compare(ranks, name, want_name=None):
    case = CASES[name]
    losses, params = JAX[want_name or name]
    for r in range(int(np.prod(case["mesh"]))):
        np.testing.assert_allclose(ranks[r][f"{name}/loss"], losses,
                                   rtol=LOSS_RTOL)
        for key, want in params.items():
            np.testing.assert_allclose(ranks[r][f"{name}/p/{key}"],
                                       _block(case, r, key, want), **TOL,
                                       err_msg=f"rank {r} {key}")


def _gap(ranks, name, want_name):
    case = CASES[name]
    _, params = JAX[want_name]
    return max(float(np.abs(ranks[r][f"{name}/p/{key}"]
                            - _block(case, r, key, want)).max())
               for r in range(int(np.prod(case["mesh"])))
               for key, want in params.items())


@pytest.mark.parametrize("name", PARITY)
def test_parity_with_jax_sharded_step(ranks, name):
    _compare(ranks, name)


@pytest.mark.parametrize("name", ["ffn_adam", "gpt_adam"])
def test_loss_decreases_as_in_jax(ranks, name):
    """JAX's tests' cases and bars (tests/test_moe.py's 0.8,
    tests/test_moe_gpt.py's 0.9); every rank holds the same curve."""
    limit = 0.8 if name == "ffn_adam" else 0.9
    for r in range(WORLD):
        got = ranks[r][f"{name}/loss"]
        np.testing.assert_array_equal(got, ranks[0][f"{name}/loss"])
        assert np.all(np.isfinite(got)) and got[-1] < got[0] * limit, got


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_comparison(ranks, fault):
    with pytest.raises(AssertionError):
        _compare(ranks, fault, FAULTS[fault])
    gap = _gap(ranks, fault, FAULTS[fault])
    assert gap > 100 * TOL["atol"], gap


@pytest.mark.parametrize("cap", [0.25, 1.25, 8.0])
def test_moe_ffn_matches_jax_with_every_expert_local(cap):
    """Outputs, aux loss and the gradients of the parameters and the
    input, one process; at 0.25 most tokens overflow."""
    jcfg = JM.MoEConfig(d_model=16, d_ff=32, n_experts=4,
                        capacity_factor=cap, dtype=jnp.float32)
    cfg = M.MoEConfig(d_model=16, d_ff=32, n_experts=4,
                      capacity_factor=cap, dtype=torch.float32)
    params = JM.init_moe_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 8, 16).astype(np.float32)
    r = rng.randn(8, 8, 16).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_ffn(p, xx, jcfg)
        return jnp.sum(y * r) + 3.0 * aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = M.moe_ffn(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(r)) + 3.0 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    if cap == 0.25:       # most tokens overflow and pass the residual
        same = np.isclose(y.detach().numpy(), x).all(axis=-1).mean()
        assert same > 0.4, same


def test_param_structure_as_jax():
    jcfg = _gpt_cfg({"experts": 8, "cap": 8.0, "aux": 0.0})
    cfg = MG.MoEGPTConfig(gpt=G.GPTConfig(**GPT, dtype=torch.float32),
                          n_experts=8, expert_every=2)
    want = _flatten(JMG.init_params(jax.random.PRNGKey(0), jcfg))
    got = _flatten(MG.init_params(torch.Generator().manual_seed(0), cfg))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    layers = MG.init_params(torch.Generator().manual_seed(0),
                            cfg)["layers"]
    assert "moe" not in layers[0] and "wi" in layers[0]
    assert "moe" in layers[1] and "wi" not in layers[1]
    assert tuple(layers[1]["moe"]["wi"].shape) == (8, 16, 32)
    # the JAX tree carries over, and a wrong shape is refused
    tree = JMG.init_params(jax.random.PRNGKey(0), jcfg)
    conv = _flatten(convert.params_from_jax(tree, cfg))
    for k, v in want.items():
        np.testing.assert_array_equal(conv[k], v)
    tree["layers"][1]["moe"]["wo"] = tree["layers"][1]["moe"]["wi"]
    with pytest.raises(ValueError, match="moe/wo"):
        convert.params_from_jax(tree, cfg)


def test_param_specs_as_jax():
    jcfg = _gpt_cfg({"experts": 8, "cap": 8.0, "aux": 0.0})
    cfg = MG.MoEGPTConfig(gpt=G.GPTConfig(**GPT), n_experts=8)

    def norm(node):
        if isinstance(node, dict):
            return {k: norm(v) for k, v in node.items()}
        if isinstance(node, list):
            return [norm(v) for v in node]
        spec = list(node)
        while spec and spec[-1] is None:
            spec.pop()
        return spec
    assert norm(MG.param_specs(cfg)) == norm(JMG.param_specs(jcfg))
    assert norm(M.moe_param_specs()) == norm(JM.moe_param_specs("ep"))


class _Mesh:
    def __init__(self, **sizes):
        self._sizes = sizes

    def size(self, *axes):
        return int(np.prod([self._sizes[a] for a in axes]))

    def group(self, *axes):
        return None


def test_expert_divisibility_as_jax():
    cfg = M.MoEConfig(d_model=16, d_ff=32, n_experts=6)
    with pytest.raises(ValueError, match="not divisible"):
        M.make_moe_step(cfg, None, _Mesh(dp=1, ep=4), {})
    gcfg = MG.MoEGPTConfig(gpt=G.GPTConfig(**GPT), n_experts=6)
    with pytest.raises(ValueError, match="not divisible"):
        MG.make_train_step(gcfg, None, _Mesh(dp=1, ep=4), {})


def test_example_trains_on_the_cpu(ranks):
    code, losses, err = EXAMPLE["run"]
    assert code == 0, err
    assert len(losses) == 3 and np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
