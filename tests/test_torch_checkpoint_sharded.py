"""The port's sharded checkpoints and re-shards against JAX's.

Four gloo ranks, spawned once for the module, run every case:

- a global [8, 16] array saved by ``checkpoint.Checkpointer`` as
  ``checkpoint.sharded`` blocks over 4 ranks and restored over 2 and 3
  (tests/test_checkpoint.py:61; 8 rows over 3 ranks are 3, 3 and 2 of a
  padded 3), and by this process alone into one plain tensor;
- ZeRO-3 (layerwise and flat) and ZeRO-1 jobs saved at 4 ranks after 2
  steps and resumed at 3 and 2 ranks (``fsdp.fsdp_state_dict``,
  ``fsdp.load_fsdp_state_dict``), which must keep the uninterrupted
  4-rank trajectory, itself held to JAX's;
- tests/test_elastic_tp.py:65 and :106: the GPT trained at tp 2, gathered
  (``threed.gather_params``) and re-sharded through a checkpoint at tp 4
  and then tp 1, against JAX's fixed tp 2 trajectory; and a tp degree of
  3, which does not divide the heads, raising.
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
from jax.sharding import Mesh

from kungfu_tpu.models import gpt as JG
from kungfu_tpu.parallel import (make_fsdp_scan_step, make_fsdp_step,
                                 make_zero1_step)
from kungfu_tpu.parallel import threed as JT3
from kungfu_tpu_torch.checkpoint import Checkpointer
from kungfu_tpu_torch.examples.ranks import launch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
GLOBAL = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
# tests/test_elastic_tp.py's model, batches and limits
TP_CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=16)
TP_STAGES = ((2, 3), (4, 3), (1, 3))     # (tp degree, steps)
TP_LOSS_RTOL = 2e-4
TP_TOL = {"rtol": 3e-4, "atol": 1e-6}
# a resumed job against the uninterrupted one: the same Adam updates on
# gradients summed in another order over 3 or 2 ranks
RESUME_LOSS_RTOL = 1e-5
RESUME_TOL = {"rtol": 1e-5, "atol": 1e-6}
RESUME = {"scan": (3, 2), "flat": (3,), "zero1": (2,)}
RESUME_STEPS = (2, 2)            # before the save, after it
D = 24                            # the resumed jobs' width
ROWS = 12                         # divides over 4, 3 and 2 ranks


def _resume_inputs():
    """tests/test_fsdp_scan.py's model at width 24, 3 layers."""
    rng = np.random.RandomState(5)
    f = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)
    params = {"embed": {"w_in": f(16, D)},
              "layers": {"w": f(3, D, D), "b": np.zeros((3, D), np.float32)},
              "head": {"w_out": f(D, 4)}}
    batch = (rng.randn(ROWS, 16).astype(np.float32),
             rng.randn(ROWS, 4).astype(np.float32))
    return params, batch


def _tp_batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(sum(s for _, s in TP_STAGES)):
        out.append((rng.randint(0, 64, (2, 8)).astype(np.int32),
                    rng.randint(0, 64, (2, 8)).astype(np.int32)))
    return out


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
    from kungfu_tpu_torch.checkpoint import (Checkpointer, local_block,
                                             sharded)
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.models import gpt as G
    from kungfu_tpu_torch.parallel import fsdp as FS
    from kungfu_tpu_torch.parallel import threed as T3
    from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    init_process_group_file(f"{tmp}/store", rank, world, "gloo",
                            timeout_s=120)
    plan = json.load(open(f"{tmp}/plan.json"))
    flat = dict(np.load(f"{tmp}/in.npz"))
    subs = {n: dist.new_group(list(range(n))) for n in (2, 3)}
    subs[4] = None
    res = {}

    def tree(prefix):
        out = {}
        for key, v in flat.items():
            if key.startswith(prefix + "/"):
                *path, leaf = key[len(prefix) + 1:].split("/")
                node = out
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = torch.from_numpy(v)
        if "layers" in out and isinstance(out["layers"], dict) \\
                and "0" in out["layers"]:
            out["layers"] = [out["layers"][str(i)]
                             for i in range(len(out["layers"]))]
        return out

    # 1. a global [8, 16] array: 4 ranks save, 2 and 3 restore
    x = torch.from_numpy(flat["global"])
    ck = Checkpointer(f"{tmp}/ck_global")
    ck.save(1, {"w": sharded(x.chunk(4)[rank].clone(), 8, None, 0)},
            meta={"rows": 8})
    for n in (2, 3):
        if rank < n:
            c = -(-8 // n)
            like = {"w": sharded(torch.zeros(c, 16), 8, subs[n], 0)}
            step, got, meta = ck.restore(like)
            res[f"global/{n}"] = local_block(got["w"], c).numpy()
            res[f"global/{n}/meta"] = np.array(meta["rows"])
        dist.barrier()

    # 2. ZeRO-3 and ZeRO-1 resumed at another rank count
    def embed(ep, b):
        return torch.tanh(b[0] @ ep["w_in"])

    def layer(lp, a):
        return a + torch.tanh(a @ lp["w"] + lp["b"])

    def head(hp, a, b):
        return ((a @ hp["w_out"] - b[1]) ** 2).mean()

    def flat_loss(p, b):
        a = embed(p["embed"], b)
        for i in range(p["layers"]["w"].shape[0]):
            a = layer({k: v[i] for k, v in p["layers"].items()}, a)
        return head(p["head"], a, b)

    def job(kind, group):
        make_opt = lambda ps: torch.optim.Adam(ps, lr=plan["lr"])
        if kind == "scan":
            init, make_step = FS.make_fsdp_scan_step(embed, layer, head,
                                                     make_opt, group)
        else:
            maker = FS.make_fsdp_step if kind == "flat" else FS.make_zero1_step
            init, make_step = maker(flat_loss, make_opt, group)
        shards, opt, meta = init(tree("resume/params"))
        return shards, opt, meta, make_step(meta)

    def state_of(shards, meta):
        out = shards if isinstance(shards, dict) else {"flat": shards}
        return {k: v.detach().numpy() for k, v in out.items()}

    batch = (torch.from_numpy(flat["resume/batch/0"]),
             torch.from_numpy(flat["resume/batch/1"]))
    before, after = plan["resume_steps"]
    for kind, sizes in plan["resume"].items():
        shards, opt, meta, step = job(kind, None)
        losses = [float(step(shards, opt, batch)) for _ in range(before)]
        ck = Checkpointer(f"{tmp}/ck_{kind}")
        assert ck.save(before, FS.fsdp_state_dict(shards, opt, meta),
                       meta={"kind": kind})
        losses += [float(step(shards, opt, batch)) for _ in range(after)]
        res[f"{kind}/4/loss"] = np.array(losses)
        for k, v in state_of(shards, meta).items():
            res[f"{kind}/4/p/{k}"] = v
        for n in sizes:
            if rank < n:
                shards, opt, meta, step = job(kind, subs[n])
                at, mj = FS.load_fsdp_state_dict(ck, shards, opt, meta)
                assert at == before and mj == {"kind": kind}, (at, mj)
                res[f"{kind}/{n}/loss"] = np.array(
                    [float(step(shards, opt, batch)) for _ in range(after)])
                for k, v in state_of(shards, meta).items():
                    res[f"{kind}/{n}/p/{k}"] = v
            dist.barrier()

    # 3. the GPT at tp 2 -> 4 -> 1 through a checkpoint
    cfg = G.GPTConfig(**plan["tp_cfg"], dtype=torch.float32)
    meshes = {tp: T3.mesh_3d(1, 1, tp, timeout_s=120) for tp in (1, 2, 3, 4)}
    try:
        if meshes[3] is not None:
            T3.shard_params(convert.params_from_jax(tree("tp/init"), cfg),
                            cfg, meshes[3])
        res["tp3_raised"] = np.array(False)
    except ValueError:
        res["tp3_raised"] = np.array(True)
    full = convert.params_from_jax(tree("tp/init"), cfg)
    moments, adam_step = None, None
    losses, i = [], 0
    ck = Checkpointer(f"{tmp}/ck_tp")
    prev = None
    for stage, (tp, steps) in enumerate(plan["tp_stages"]):
        mesh = meshes[tp]
        if mesh is not None:
            params = T3.shard_params(full, cfg, mesh)
            opt = torch.optim.Adam(tree_leaves(params), lr=1e-2)
            if moments is not None:
                local = {k: tree_leaves(T3.shard_params(m, cfg, mesh))
                         for k, m in moments.items()}
                for j, p in enumerate(tree_leaves(params)):
                    opt.state[p] = {"step": adam_step.clone(),
                                    **{k: v[j] for k, v in local.items()}}
            step = T3.make_gpt_train_step(cfg, opt, mesh, params)
            for _ in range(steps):
                b = [torch.from_numpy(flat[f"tp/batch/{i}/{k}"])
                     for k in (0, 1)]
                losses.append(float(step(*b)))
                i += 1
            # gather the global state and write it (rank 0 of the mesh)
            glob = {"params": T3.gather_params(params, cfg, mesh),
                    "opt": {k: T3.gather_params(tree_map(
                        lambda p: opt.state[p][k], params), cfg, mesh)
                        for k in ("exp_avg", "exp_avg_sq")},
                    "step": opt.state[tree_leaves(params)[0]]["step"]}
            ck.save(stage, glob)
            ck.wait()
        else:
            i += steps
        dist.barrier()
        _, got, _ = ck.restore(step=stage)
        full, moments, adam_step = got["params"], got["opt"], got["step"]
    if rank == 0:
        res["tp/loss"] = np.array(losses)
        for j, v in enumerate(tree_leaves(full)):
            res[f"tp/final/{j}"] = v.numpy()
    np.savez(f"{tmp}/out{rank}.npz", **res)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_sharded")
    flat = {"global": GLOBAL}
    params, batch = _resume_inputs()
    flat.update(_flatten(params, "resume/params/"))
    flat["resume/batch/0"], flat["resume/batch/1"] = batch
    init = JG.init_params(jax.random.PRNGKey(0), _tp_cfg())
    flat.update(_flatten(jax.device_get(init), "tp/init/"))
    for i, (tok, tgt) in enumerate(_tp_batches()):
        flat[f"tp/batch/{i}/0"], flat[f"tp/batch/{i}/1"] = tok, tgt
    np.savez(tmp / "in.npz", **flat)
    plan = {"lr": 1e-2, "resume": RESUME, "resume_steps": RESUME_STEPS,
            "tp_cfg": TP_CFG, "tp_stages": TP_STAGES}
    (tmp / "plan.json").write_text(json.dumps(plan))
    i, code = launch(
        [[sys.executable, "-c", WORKER, str(r), str(WORLD), str(tmp)]
         for r in range(WORLD)],
        dict(os.environ, PYTHONPATH=str(REPO)), REPO, 300, tmp)
    assert i is None, (code, (tmp / f"{i}.log").read_text())
    return tmp, [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]


def _tp_cfg():
    return JG.GPTConfig(**TP_CFG, dtype=jnp.float32)


@pytest.mark.parametrize("n", [2, 3])
def test_restore_resharded_same_global_shape(ranks, n):
    """tests/test_checkpoint.py:61: blocks written by 4 ranks re-laid
    over n; each rank's padded block holds its ceil(8 / n) rows."""
    _, res = ranks
    c = -(-8 // n)
    padded = np.concatenate([GLOBAL, np.zeros((c * n - 8, 16), np.float32)])
    for r in range(n):
        np.testing.assert_array_equal(res[r][f"global/{n}"],
                                      padded[r * c:(r + 1) * c])
        assert int(res[r][f"global/{n}/meta"]) == 8


def test_restore_sharded_into_one_process(ranks):
    """Without a group, a template of plain tensors takes the whole."""
    tmp, _ = ranks
    ck = Checkpointer(str(tmp / "ck_global"))
    assert ck.all_steps() == [1]
    assert ck.saved_keys() == {"w": ((8, 16), torch.float32)}
    step, got, meta = ck.restore({"w": torch.zeros(8, 16)})
    assert step == 1 and meta == {"rows": 8}
    np.testing.assert_array_equal(got["w"].numpy(), GLOBAL)
    with pytest.raises(ValueError):
        ck.restore()


def _jax_resume(kind):
    """JAX's uninterrupted 4-device run of the resumed jobs' model."""
    params, batch = _resume_inputs()
    params = jax.tree_util.tree_map(jnp.asarray, params)
    batch = tuple(jnp.asarray(b) for b in batch)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("fsdp",))

    def embed(ep, b):
        return jnp.tanh(b[0] @ ep["w_in"])

    def layer(lp, a):
        return a + jnp.tanh(a @ lp["w"] + lp["b"])

    def head(hp, a, b):
        return jnp.mean((a @ hp["w_out"] - b[1]) ** 2)

    def flat_loss(p, b):
        a = embed(p["embed"], b)
        a, _ = jax.lax.scan(lambda a, lp: (layer(lp, a), None), a,
                            p["layers"])
        return head(p["head"], a, b)

    opt = optax.adam(1e-2)
    if kind == "scan":
        init, make = make_fsdp_scan_step(embed, layer, head, opt, mesh)
    else:
        init, make = (make_fsdp_step if kind == "flat" else make_zero1_step)(
            flat_loss, opt, mesh)
    state, st, meta = init(params)
    step = make(meta)
    losses = []
    for _ in range(sum(RESUME_STEPS)):
        state, st, loss = step(state, st, batch)
        losses.append(float(np.asarray(loss)))
    return np.array(losses)


@pytest.mark.parametrize("kind,n", [(k, n) for k, ns in RESUME.items()
                                    for n in ns])
def test_resume_at_another_rank_count_keeps_the_trajectory(ranks, kind, n):
    """A job saved at 4 ranks after 2 steps and resumed at n takes the
    same 2 further steps as the job that went on at 4, whose losses are
    JAX's; the resumed layout holds the same vector."""
    _, res = ranks
    before, _ = RESUME_STEPS
    full = res[0][f"{kind}/4/loss"]
    np.testing.assert_allclose(full, _jax_resume(kind), rtol=1e-4)
    for r in range(n):
        np.testing.assert_allclose(res[r][f"{kind}/{n}/loss"],
                                   full[before:], rtol=RESUME_LOSS_RTOL)
    for key in [k.split("/p/")[1] for k in res[0]
                if k.startswith(f"{kind}/4/p/")]:
        if kind == "zero1":
            want = res[0][f"{kind}/4/p/{key}"]
            got = res[n - 1][f"{kind}/{n}/p/{key}"]
            size = min(want.shape[-1], got.shape[-1])
            want, got = want[..., :size], got[..., :size]
        else:
            want = np.concatenate([res[r][f"{kind}/4/p/{key}"]
                                   for r in range(WORLD)], axis=-1)
            got = np.concatenate([res[r][f"{kind}/{n}/p/{key}"]
                                  for r in range(n)], axis=-1)
            size = min(want.shape[-1], got.shape[-1])
            # past the unpadded size both are zero padding
            assert not got[..., size:].any() and not want[..., size:].any()
            want, got = want[..., :size], got[..., :size]
        np.testing.assert_allclose(got, want, **RESUME_TOL, err_msg=key)


@functools.lru_cache(maxsize=None)
def _jax_tp_oracle():
    """tests/test_elastic_tp.py:65's oracle: tp 2 for every step."""
    devices = jax.devices()
    opt = optax.adam(1e-2)
    mesh = JT3.mesh_3d(1, 1, 2, devices[:2])
    params, state = JT3.init_gpt(_tp_cfg(), opt, mesh)
    step = JT3.make_gpt_train_step(_tp_cfg(), opt, mesh, donate=False)
    losses = []
    for tok, tgt in _tp_batches():
        params, state, loss = step(params, state, jnp.asarray(tok),
                                   jnp.asarray(tgt))
        losses.append(float(loss))
    return np.array(losses), jax.device_get(params)


def test_tp_degree_change_preserves_trajectory(ranks):
    """tests/test_elastic_tp.py:65: tp 2 (3 steps) -> 4 (3) -> 1 (3),
    each change a gather, a checkpoint and a re-shard of the parameters
    and Adam's moments, on JAX's fixed-degree trajectory."""
    _, res = ranks
    want_losses, want = _jax_tp_oracle()
    np.testing.assert_allclose(res[0]["tp/loss"], want_losses,
                               rtol=TP_LOSS_RTOL)
    leaves = jax.tree_util.tree_leaves(want)
    assert len(leaves) == len([k for k in res[0] if k.startswith("tp/final/")])
    for i, w in enumerate(leaves):
        np.testing.assert_allclose(res[0][f"tp/final/{i}"], np.asarray(w),
                                   **TP_TOL)


def test_tp_reshard_rejects_indivisible_degree(ranks):
    """tests/test_elastic_tp.py:106: 4 heads do not shard over 3."""
    _, res = ranks
    for r in range(3):
        assert bool(res[r]["tp3_raised"])
    assert not bool(res[3]["tp3_raised"])
