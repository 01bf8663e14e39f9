"""The port's pipeline step (dp x pp, x tp, interleaved, remat) against JAX's.

Eight gloo ranks, spawned once for the module, run
``kungfu_tpu_torch.parallel.pipeline.make_gpt_pp_train_step`` on every
case of tests/test_pipeline.py's parity matrix, from the JAX init carried
across (``convert.params_from_jax``, ``stack_layers``,
``interleave_params``, ``shard_params``); the test side runs
``kungfu_tpu.parallel.pipeline.make_gpt_pp_train_step`` on the same mesh
shape over the conftest's virtual devices.  Each rank's loss and
post-step parameter blocks must equal JAX's (SGD: Adam would hide a
uniform gradient scale).  Also: remat at v = 1 and v = 2, the Adam loss
curve, the pure functions (the tick count brute-forced, the interleave
order, its inverse, stacking), the validation raises, the example, and
three planted faults (replicated leaves not summed over pp, the
interleave order not applied, dx sent forward instead of back), each of
which must fail the comparison.  A mesh of fewer than eight ranks runs on
the first ranks; the others only take part in forming its groups.
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
from kungfu_tpu.parallel import pipeline as JPP
from kungfu_tpu_torch.examples.ranks import launch
from kungfu_tpu_torch.models import gpt as G
from kungfu_tpu_torch.parallel import pipeline as PP
from kungfu_tpu_torch.utils.tree import tree_leaves

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
BASE = dict(vocab_size=64, d_model=16, n_heads=4, d_ff=32, max_seq=32)
# tests/test_gpt3d.py's limits for its parity against one device
LOSS_RTOL = 1e-4
TOL = {"rtol": 2e-4, "atol": 2e-5}


def _case(mesh, layers, micro, v=1, remat=False, opt="sgd", lr=0.1,
          steps=1, data=(4, 8, 0), seed=0, fault=None):
    return {"mesh": list(mesh), "layers": layers, "micro": micro, "v": v,
            "remat": remat, "opt": opt, "lr": lr, "steps": steps,
            "data": list(data), "seed": seed, "fault": fault}


CASES = {}
for dp, pp, L, M in [(2, 2, 2, 2), (1, 4, 4, 4), (2, 4, 4, 2)]:
    CASES[f"gpipe_{dp}{pp}_{L}l_{M}m"] = _case((dp, pp), L, M)
for dp, pp, v, L, M in [(2, 2, 2, 4, 2), (1, 4, 2, 8, 4), (2, 2, 2, 4, 3),
                        (1, 2, 3, 6, 4)]:
    CASES[f"inter_{dp}{pp}_v{v}_{L}l_{M}m"] = _case(
        (dp, pp), L, M, v=v, data=(6 if M == 3 else 4, 8, 0))
for dp, pp, tp, L, M in [(2, 2, 2, 2, 2), (1, 2, 4, 2, 2)]:
    CASES[f"tp_{dp}{pp}{tp}_{L}l_{M}m"] = _case((dp, pp, tp), L, M)
PARITY = list(CASES)
CASES.update({
    "remat_v1": _case((2, 2), 2, 4, remat=True, data=(8, 16, 2), seed=3),
    "noremat_v1": _case((2, 2), 2, 4, data=(8, 16, 2), seed=3),
    "remat_v2": _case((2, 2), 4, 4, v=2, remat=True, data=(8, 16, 2),
                      seed=3),
    "noremat_v2": _case((2, 2), 4, 4, v=2, data=(8, 16, 2), seed=3),
    "adam": _case((2, 2), 2, 4, opt="adam", lr=1e-2, steps=8,
                  data=(8, 16, 1), seed=1),
})
# planted faults: the case they corrupt
FAULTS = {"pp_sum_skipped": "gpipe_22_2l_2m",
          "no_interleave": "inter_14_v2_8l_4m",
          "dx_forward": "gpipe_14_4l_4m"}
for _f, _c in FAULTS.items():
    CASES[_f] = dict(CASES[_c], fault=_f)


def _jcfg(layers):
    return JG.GPTConfig(**BASE, n_layers=layers, dtype=jnp.float32)


def _data(layers, batch, seq, seed):
    rng = np.random.RandomState(seed)
    V = BASE["vocab_size"]
    return (rng.randint(0, V, (batch, seq)).astype(np.int32),
            rng.randint(0, V, (batch, seq)).astype(np.int32))


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
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import convert
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.models import gpt as G
    from kungfu_tpu_torch.parallel import pipeline as PP
    from kungfu_tpu_torch.utils.tree import tree_leaves

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    init_process_group_file(f"{tmp}/store", rank, world, "gloo",
                            timeout_s=120)
    plan = json.load(open(f"{tmp}/plan.json"))
    flat = dict(np.load(f"{tmp}/in.npz"))
    meshes = {}
    for m in plan["meshes"]:
        make = PP.mesh_dp_pp if len(m) == 2 else PP.mesh_dp_pp_tp
        meshes[tuple(m)] = make(*m, timeout_s=120)

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
        tree["layers"] = [tree["layers"][str(i)]
                          for i in range(len(tree["layers"]))]
        return tree

    def named(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree)
                    for x in named(tree[k], f"{prefix}{k}/")]
        return [(prefix[:-1], tree)]

    def pp_sum_skipped(masters, layer_leaf, mesh):
        # every gradient summed over dp only
        if mesh.size("dp") > 1:
            for m in masters:
                dist.all_reduce(m.grad, group=mesh.group("dp"))

    def dx_forward(orig):
        def run(x, group, shift=1, ring=False):
            return orig(x, group, abs(shift), ring)
        return run

    res = {}
    for name, case in plan["cases"].items():
        mesh = meshes[tuple(case["mesh"])]
        if mesh is None:
            continue
        cfg = G.GPTConfig(**plan["base"], n_layers=case["layers"],
                          dtype=torch.float32)
        saved = (PP._sync_gradients, PP.interleave_layer_order,
                 C.stage_handoff)
        if case["fault"] == "pp_sum_skipped":
            PP._sync_gradients = pp_sum_skipped
        elif case["fault"] == "no_interleave":
            PP.interleave_layer_order = lambda n, S, v: np.arange(n)
        elif case["fault"] == "dx_forward":
            C.stage_handoff = dx_forward(C.stage_handoff)
        full = convert.params_from_jax(
            unflatten(f"init/{case['layers']}/{case['seed']}"), cfg)
        S = mesh.size("pp")
        params = PP.shard_params(
            PP.interleave_params(PP.stack_layers(full), cfg.n_layers, S,
                                 case["v"]), cfg, mesh)
        leaves = tree_leaves(params)
        opt = (torch.optim.SGD(leaves, lr=case["lr"]) if case["opt"] == "sgd"
               else torch.optim.Adam(leaves, lr=case["lr"]))
        step = PP.make_gpt_pp_train_step(
            cfg, opt, mesh, params, n_micro=case["micro"],
            remat=case["remat"], virtual_stages=case["v"])
        b, s, sd = case["data"]
        tok = torch.from_numpy(flat[f"data/{b}_{s}_{sd}/tokens"])
        tgt = torch.from_numpy(flat[f"data/{b}_{s}_{sd}/targets"])
        res[f"{name}/loss"] = np.array(
            [float(step(tok, tgt)) for _ in range(case["steps"])])
        (PP._sync_gradients, PP.interleave_layer_order,
         C.stage_handoff) = saved
        for key, t in named(params):
            res[f"{name}/p/{key}"] = t.detach().numpy()
    # a local batch of 3 rows over 2 microbatches raises before any
    # hand-off, as JAX's step does
    mesh = meshes[(2, 2)]
    if mesh is not None:
        cfg = G.GPTConfig(**plan["base"], n_layers=2, dtype=torch.float32)
        params = PP.init_gpt_pp(cfg, mesh, seed=0, device="cpu")
        step = PP.make_gpt_pp_train_step(
            cfg, torch.optim.SGD(tree_leaves(params), lr=0.1), mesh, params,
            n_micro=2)
        tok = torch.zeros((6, 8), dtype=torch.int64)
        try:
            step(tok, tok)
        except ValueError as e:
            res["bad_batch"] = np.array(str(e))
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")


EXAMPLE = {}
JAX = {}      # name -> JAX's (losses, params), filled by the fixture
# the Adam curve is held to JAX's test's bar, not run by JAX here
JAX_RUNS = [n for n, c in CASES.items() if c["fault"] is None
            and c["opt"] == "sgd" and not n.startswith("noremat")]


def _example():
    """The example at (1, 2, 1), v = 2, 3 steps: (exit code, losses,
    stderr)."""
    import subprocess
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.examples.gpt_pipeline",
         "--device", "cpu", "--dp", "1", "--tp", "1", "--steps", "3",
         "--virtual-stages", "2"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    losses = [float(line.split("loss=")[1]) for line in r.stdout.splitlines()
              if "loss=" in line]
    return r.returncode, losses, r.stderr[-3000:]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of the port, from eight gloo ranks spawned once (one
    npz of results per rank); JAX's runs (into ``JAX``) and the
    example's meanwhile."""
    tmp = tmp_path_factory.mktemp("pipeline")
    flat = {}
    for case in CASES.values():
        key = f"init/{case['layers']}/{case['seed']}"
        if not any(k.startswith(key + "/") for k in flat):
            tree = JG.init_params(jax.random.PRNGKey(case["seed"]),
                                  _jcfg(case["layers"]))
            flat.update(_flatten(tree, key + "/"))
        b, s, sd = case["data"]
        tok, tgt = _data(case["layers"], b, s, sd)
        flat[f"data/{b}_{s}_{sd}/tokens"] = tok
        flat[f"data/{b}_{s}_{sd}/targets"] = tgt
    np.savez(tmp / "in.npz", **flat)
    meshes = sorted({tuple(c["mesh"]) for c in CASES.values()})
    plan = {"cases": CASES, "base": BASE, "meshes": meshes}
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


def _jax_mesh(mesh):
    if len(mesh) == 2:
        return JPP.mesh_dp_pp(*mesh, jax.devices())
    return JPP.mesh_dp_pp_tp(*mesh, jax.devices())


def jax_run(name):
    """JAX's pipeline step on the case's mesh: (losses, the full
    post-step stacked, interleaved tree flattened by key)."""
    case = CASES[name]
    cfg = _jcfg(case["layers"])
    opt = (optax.sgd(case["lr"]) if case["opt"] == "sgd"
           else optax.adam(case["lr"]))
    mesh = _jax_mesh(case["mesh"])
    params, state = JPP.init_gpt_pp(cfg, opt, mesh, seed=case["seed"],
                                    virtual_stages=case["v"])
    step = JPP.make_gpt_pp_train_step(
        cfg, opt, mesh, n_micro=case["micro"], donate=False,
        remat=case["remat"], virtual_stages=case["v"])
    tokens, targets = (jnp.asarray(a) for a in _data(case["layers"],
                                                     *case["data"]))
    losses = []
    for _ in range(case["steps"]):
        params, state, loss = step(params, state, tokens, targets)
        losses.append(float(loss))
    return np.array(losses), _flatten(jax.device_get(params))


def _spec_flat(tree, prefix=""):
    """A spec tree flattened by key, its tuples kept whole."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_spec_flat(tree[k], f"{prefix}{k}/"))
        return out
    spec = list(tree)
    while spec and spec[-1] is None:     # JAX's trailing Nones
        spec.pop()
    return {prefix[:-1]: spec}


def _blocks(case, r):
    """key -> slicer of the full tree's leaf to rank r's block."""
    mesh = case["mesh"]
    tp = mesh[2] if len(mesh) == 3 else 1
    s, t = (r // tp) % mesh[1], r % tp
    specs = _spec_flat(PP.pp_param_specs(
        G.GPTConfig(**BASE, n_layers=case["layers"]),
        "tp" if len(mesh) == 3 else None))

    def slicer(key):
        spec = tuple(specs[key])

        def take(a):
            for dim, ax in enumerate(spec):
                if ax == "pp":
                    a = np.split(a, mesh[1], axis=dim)[s]
                elif ax == "tp":
                    a = np.split(a, tp, axis=dim)[t]
            return a
        return take
    return slicer


def _gap(ranks, name, want_name):
    """The largest |port - JAX| over the case's ranks and parameters."""
    case = CASES[name]
    losses, params = JAX[want_name]
    gap = 0.0
    for r in range(int(np.prod(case["mesh"]))):
        sl = _blocks(case, r)
        for key, want in params.items():
            got = ranks[r][f"{name}/p/{key}"]
            gap = max(gap, float(np.abs(got - sl(key)(want)).max()))
    return gap


def _compare(ranks, name, want_name=None):
    """Each rank's losses and parameter blocks against JAX's run of
    ``want_name`` (default: the case itself)."""
    case = CASES[name]
    losses, params = JAX[want_name or name]
    for r in range(int(np.prod(case["mesh"]))):
        np.testing.assert_allclose(ranks[r][f"{name}/loss"], losses,
                                   rtol=LOSS_RTOL)
        sl = _blocks(case, r)
        for key, want in params.items():
            np.testing.assert_allclose(ranks[r][f"{name}/p/{key}"],
                                       sl(key)(want), **TOL,
                                       err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("name", PARITY)
def test_parity_with_jax(ranks, name):
    _compare(ranks, name)


@pytest.mark.parametrize("v", [1, 2])
def test_remat_matches_jax_and_no_remat(ranks, v):
    """remat re-runs each unit's forward in the backward; the step equals
    JAX's remat step and the port's own run without it."""
    _compare(ranks, f"remat_v{v}")
    _compare(ranks, f"noremat_v{v}", f"remat_v{v}")
    for r in range(4):
        for key in ranks[r]:
            if key.startswith(f"remat_v{v}/"):
                np.testing.assert_allclose(
                    ranks[r][key],
                    ranks[r][key.replace("remat", "noremat", 1)],
                    rtol=1e-5, atol=1e-6)


def test_loss_decreases_as_in_jax(ranks):
    """tests/test_pipeline.py's case and bar (0.9); every rank holds the
    same curve."""
    for r in range(4):
        got = ranks[r]["adam/loss"]
        np.testing.assert_array_equal(got, ranks[0]["adam/loss"])
        assert np.all(np.isfinite(got)) and got[-1] < got[0] * 0.9, got


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_comparison(ranks, fault):
    with pytest.raises(AssertionError):
        _compare(ranks, fault, FAULTS[fault])
    gap = _gap(ranks, fault, FAULTS[fault])
    assert gap > 100 * TOL["atol"], gap


def test_schedule_ticks_as_jax():
    """Brute-force the interleaved schedule as tests/test_pipeline.py
    does: no rank holds two units in a tick, the last tick is the
    formula's, and the port's tick decode places every unit there."""
    for S in (2, 3, 4):
        for v in (1, 2, 3):
            for M in (1, 2, 3, 4, 6, 8):
                e = lambda m: (m // S) * v * S + m % S
                busy, last = {}, -1
                for m in range(M):
                    for c in range(S * v):
                        t = e(m) + c
                        assert (t, c % S) not in busy
                        busy[(t, c % S)] = (c // S, m)
                        last = max(last, t)
                n = PP.pp_schedule_ticks(S, M, v)
                assert n == last + 1 == JPP.pp_schedule_ticks(S, M, v)
                if M % S == 0:
                    assert n == v * M + S - 1
                for t in range(n):
                    for r in range(S):
                        assert PP._unit(t, r, S, M, v) == busy.get((t, r))


@pytest.mark.parametrize("L,S,v", [(4, 2, 2), (8, 4, 2), (6, 2, 3),
                                   (12, 2, 3), (4, 2, 1), (5, 2, 2)])
def test_interleave_order_and_inverse_as_jax(L, S, v):
    def outcome(fn):
        try:
            return list(fn(L, S, v))
        except ValueError as e:
            return str(e)
    assert outcome(PP.interleave_layer_order) == outcome(
        JPP.interleave_layer_order)
    if isinstance(outcome(PP.interleave_layer_order), str):
        return
    cfg = G.GPTConfig(**BASE, n_layers=L, dtype=torch.float32)
    full = G.init_params(torch.Generator().manual_seed(0), cfg)
    stacked = PP.stack_layers(full)
    inter = PP.interleave_params(stacked, L, S, v)
    want = JPP.deinterleave_params(
        {"layers": {k: np.asarray(t) for k, t in inter["layers"].items()}},
        L, S, v)
    back = PP.deinterleave_params(inter, L, S, v)
    for k, t in back["layers"].items():
        assert torch.equal(t, stacked["layers"][k])
        np.testing.assert_array_equal(t.numpy(), want["layers"][k])
    un = PP.unstack_layers(back, L)
    for a, b in zip(un["layers"], full["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_stack_layers_as_jax():
    jcfg = _jcfg(3)
    tree = JG.init_params(jax.random.PRNGKey(0), jcfg)
    want = _flatten(jax.device_get(JPP.stack_layers(tree)))
    from kungfu_tpu_torch import convert
    got = _flatten(PP.stack_layers(convert.params_from_jax(
        tree, G.GPTConfig(**BASE, n_layers=3, dtype=torch.float32))))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("tp", [None, "tp"])
def test_param_specs_match_jax(tp):
    for cfg_kw in (BASE, dict(BASE, rope=True, mlp="swiglu")):
        got = PP.pp_param_specs(G.GPTConfig(**cfg_kw, n_layers=2), tp)
        want = JPP.pp_param_specs(JG.GPTConfig(**cfg_kw, n_layers=2), tp=tp)
        assert _spec_flat(got) == _spec_flat(want)


class _Mesh:
    """A stand-in ProcessMesh for the checks that raise before any
    collective."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self._sizes = sizes

    def size(self, *axes):
        return int(np.prod([self._sizes[a] for a in axes]))


def _raises(cfg_kw, mesh, v=1):
    with pytest.raises(ValueError) as e:
        PP.make_gpt_pp_train_step(G.GPTConfig(**cfg_kw), None, mesh, {},
                                  n_micro=2, virtual_stages=v)
    return str(e.value)


def test_validation_as_jax():
    assert "not divisible" in _raises(dict(BASE, n_layers=3),
                                      _Mesh(dp=1, pp=2))
    assert "virtual" in _raises(dict(BASE, n_layers=4), _Mesh(dp=1, pp=2),
                                v=3)
    assert "tensor-parallel" in _raises(
        dict(BASE, d_model=18, n_heads=6, n_layers=2),
        _Mesh(dp=1, pp=2, tp=4))
    assert "virtual_stages" in _raises(dict(BASE, n_layers=2),
                                       _Mesh(dp=1, pp=2), v=0)


def test_local_batch_must_split_into_microbatches(ranks):
    """At dp 2, a global batch of 6 rows leaves each rank 3, which do not
    split into 2 microbatches: every rank raises JAX's message."""
    for r in range(4):
        assert str(ranks[r]["bad_batch"]) == (
            "local batch 3 not divisible by 2 microbatches")


def test_example_trains_on_the_cpu(ranks):
    """``python -m kungfu_tpu_torch.examples.gpt_pipeline --device cpu``
    at (1, 2, 1), two virtual stages (run beside the pool): the loss
    falls."""
    code, losses, err = EXAMPLE["run"]
    assert code == 0, err
    assert len(losses) == 3 and np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
