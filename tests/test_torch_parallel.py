"""Sequence and tensor parallelism of the port against JAX.

The port's ``ring_attention``, ``ring_flash_attention`` (the plain flash
version on the CPU), ``ulysses_attention``, ``column_parallel`` /
``row_parallel`` and the differentiable collectives (``ppermute``,
``all_to_all``) run in gloo ranks on their shards; the same functions of
the JAX package run under ``shard_map`` on the conftest's virtual devices
(ring_flash through its in-shard jnp path).  Forward and gradients, the
gradients as the vector-Jacobian product with a seeded cotangent, causal
and not, with GQA's compact KV heads.  Two worlds (2 and 4 ranks) are
spawned once for the module, side by side.
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
import pytest
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from kungfu_tpu.parallel import (column_parallel as jcolumn,
                                 ring_attention as jring,
                                 ring_flash_attention as jring_flash,
                                 row_parallel as jrow,
                                 ulysses_attention as julysses)
from kungfu_tpu_torch.examples.ranks import launch

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
B, T, H, D = 2, 32, 8, 8
# f32 on both sides, the same algorithm: the port and JAX differ only in
# the order of f32 sums (and exp against exp2 in the flash backward)
TOL = {"rtol": 1e-4, "atol": 2e-5}
ATTN = [(kind, n, causal, g) for kind in ("ring", "ring_flash", "ulysses")
        for n in WORLDS for causal in (False, True) for g in (1, 2)]


def _name(kind, n, causal, g):
    return f"{kind}/n{n}/{'causal' if causal else 'full'}/g{g}"


def _inputs():
    rng = np.random.RandomState(0)
    out = {}
    for g in (1, 2):
        out[f"q{g}"] = rng.randn(B, T, H, D).astype(np.float32)
        out[f"k{g}"] = rng.randn(B, T, H // g, D).astype(np.float32)
        out[f"v{g}"] = rng.randn(B, T, H // g, D).astype(np.float32)
        out[f"ct{g}"] = rng.randn(B, T, H, D).astype(np.float32)
    out["x"] = rng.randn(8, 16).astype(np.float32)
    out["w1"] = rng.randn(16, 32).astype(np.float32)
    out["w2"] = rng.randn(32, 16).astype(np.float32)
    out["mlp_ct"] = rng.randn(8, 16).astype(np.float32)
    for n in WORLDS:
        out[f"perm_x{n}"] = rng.randn(n, 3).astype(np.float32)
        out[f"perm_ct{n}"] = rng.randn(n, 3).astype(np.float32)
    out["a2a_x"] = rng.randn(2, 8, 4, 3).astype(np.float32)
    for n in WORLDS:
        out[f"a2a_ct{n}"] = rng.randn(2, 8, 4, 3).astype(np.float32)
    return out


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch.comm import collectives as C
    from kungfu_tpu_torch.comm.mesh import init_process_group_file
    from kungfu_tpu_torch.parallel import (column_parallel, ring_attention,
                                           ring_flash_attention,
                                           row_parallel, ulysses_attention)

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    init_process_group_file(f"{tmp}/store{world}", rank, world, "gloo",
                            timeout_s=120)
    group = dist.group.WORLD
    plan = json.load(open(f"{tmp}/plan.json"))
    inp = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/in.npz").items()}
    FNS = {"ring": ring_attention, "ring_flash": ring_flash_attention,
           "ulysses": ulysses_attention}
    res = {}

    def shard(t, axis):
        return t.chunk(world, dim=axis)[rank].contiguous()

    for kind, n, causal, g in plan["attn"]:
        if n != world:
            continue
        name = plan["names"][f"{kind}/{n}/{causal}/{g}"]
        q, k, v = (shard(inp[f"{x}{g}"], 1).requires_grad_()
                   for x in "qkv")
        out = FNS[kind](q, k, v, group, causal=causal, kv_groups=g)
        (out * shard(inp[f"ct{g}"], 1)).sum().backward()
        for key, t in (("out", out), ("dq", q.grad), ("dk", k.grad),
                       ("dv", v.grad)):
            res[f"{name}/{key}"] = t.detach().numpy()

    x = inp["x"].clone().requires_grad_()
    w1 = shard(inp["w1"], 1).requires_grad_()
    w2 = shard(inp["w2"], 0).requires_grad_()
    y = row_parallel(torch.relu(column_parallel(x, w1, group)), w2,
                     group)
    (y * inp["mlp_ct"]).sum().backward()
    for key, t in (("y", y), ("dx", x.grad), ("dw1", w1.grad),
                   ("dw2", w2.grad)):
        res[f"mlp/{key}"] = t.detach().numpy()

    x = inp[f"perm_x{world}"][rank].clone().requires_grad_()
    y = C.ppermute(x, group, shift=1)
    (y * inp[f"perm_ct{world}"][rank]).sum().backward()
    res["perm/y"], res["perm/dx"] = y.detach().numpy(), x.grad.numpy()

    x = shard(inp["a2a_x"], 1).requires_grad_()
    y = C.all_to_all(x, group, split_axis=2, concat_axis=1)
    (y * shard(inp[f"a2a_ct{world}"], 2)).sum().backward()
    res["a2a/y"], res["a2a/dx"] = y.detach().numpy(), x.grad.numpy()
    np.savez(f"{tmp}/out{world}_{rank}.npz", **res)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [npz of rank r]}: both worlds' ranks, spawned once."""
    tmp = tmp_path_factory.mktemp("parallel")
    np.savez(tmp / "in.npz", **_inputs())
    plan = {"attn": ATTN,
            "names": {f"{k}/{n}/{c}/{g}": _name(k, n, c, g)
                      for k, n, c, g in ATTN}}
    (tmp / "plan.json").write_text(json.dumps(plan))
    argvs = [[sys.executable, "-c", WORKER, str(r), str(n), str(tmp)]
             for n in WORLDS for r in range(n)]
    i, code = launch(argvs, dict(os.environ, PYTHONPATH=str(REPO)), REPO,
                     300, tmp)
    assert i is None, (code, (tmp / f"{i}.log").read_text())
    return {n: [dict(np.load(tmp / f"out{n}_{r}.npz")) for r in range(n)]
            for n in WORLDS}


def _mesh(n, axis="sp"):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _cat(ranks, n, key, axis):
    return np.concatenate([ranks[n][r][key] for r in range(n)], axis=axis)


SEQ = P(None, "sp", None, None)


def _jax_attn(kind, n, causal, g):
    inp = _inputs()
    fn = {"ring": jring, "ulysses": julysses,
          "ring_flash": functools.partial(jring_flash, block_q=8,
                                          block_k=8)}[kind]
    sm = jax.shard_map(functools.partial(fn, axis_name="sp", causal=causal,
                                         kv_groups=g),
                       mesh=_mesh(n), in_specs=(SEQ,) * 3, out_specs=SEQ)
    return _vjp(sm, [inp[f"{x}{g}"] for x in "qkv"], inp[f"ct{g}"])


def _vjp(fn, args, ct):
    """(fn(*args), its vector-Jacobian product with ct), jitted."""
    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)
    return jax.jit(run)([jnp.asarray(a) for a in args], jnp.asarray(ct))


@pytest.mark.parametrize("kind,n,causal,g", ATTN,
                         ids=[_name(*c) for c in ATTN])
def test_attention_matches_jax(ranks, kind, n, causal, g):
    out, (dq, dk, dv) = _jax_attn(kind, n, causal, g)
    name = _name(kind, n, causal, g)
    for key, want in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(_cat(ranks, n, f"{name}/{key}", 1),
                                   np.asarray(want), **TOL, err_msg=key)


@pytest.mark.parametrize("n", WORLDS)
def test_tensor_parallel_mlp_matches_jax(ranks, n):
    inp = _inputs()

    def block(x, w1_local, w2_local):
        return jrow(jax.nn.relu(jcolumn(x, w1_local)), w2_local, "tp")

    fn = jax.shard_map(block, mesh=_mesh(n, "tp"),
                       in_specs=(P(), P(None, "tp"), P("tp", None)),
                       out_specs=P())
    y, (dx, dw1, dw2) = _vjp(fn, [inp[k] for k in ("x", "w1", "w2")],
                             inp["mlp_ct"])
    for r in range(n):
        np.testing.assert_allclose(ranks[n][r]["mlp/y"], np.asarray(y),
                                   **TOL)
        np.testing.assert_allclose(ranks[n][r]["mlp/dx"], np.asarray(dx),
                                   **TOL)
    np.testing.assert_allclose(_cat(ranks, n, "mlp/dw1", 1),
                               np.asarray(dw1), **TOL)
    np.testing.assert_allclose(_cat(ranks, n, "mlp/dw2", 0),
                               np.asarray(dw2), **TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_ppermute_backward_is_the_reverse_shift(ranks, n):
    inp = _inputs()
    perm = [(i, (i + 1) % n) for i in range(n)]
    fn = jax.shard_map(lambda x: lax.ppermute(x, "sp", perm),
                       mesh=_mesh(n), in_specs=P("sp"), out_specs=P("sp"))
    y, (dx,) = _vjp(fn, [inp[f"perm_x{n}"]], inp[f"perm_ct{n}"])
    got_y = np.stack([ranks[n][r]["perm/y"] for r in range(n)])
    got_dx = np.stack([ranks[n][r]["perm/dx"] for r in range(n)])
    np.testing.assert_array_equal(got_y, np.asarray(y))
    np.testing.assert_array_equal(got_dx, np.asarray(dx))
    # rank r's value lands at r + 1; its gradient comes back from there
    np.testing.assert_array_equal(got_y, np.roll(inp[f"perm_x{n}"], 1, 0))
    np.testing.assert_array_equal(got_dx,
                                  np.roll(inp[f"perm_ct{n}"], -1, 0))


@pytest.mark.parametrize("n", WORLDS)
def test_all_to_all_backward_is_the_inverse(ranks, n):
    inp = _inputs()
    fn = jax.shard_map(
        lambda x: lax.all_to_all(x, "sp", split_axis=2, concat_axis=1,
                                 tiled=True),
        mesh=_mesh(n), in_specs=P(None, "sp"), out_specs=P(None, None, "sp"))
    y, (dx,) = _vjp(fn, [inp["a2a_x"]], inp[f"a2a_ct{n}"])
    np.testing.assert_array_equal(_cat(ranks, n, "a2a/y", 2), np.asarray(y))
    np.testing.assert_array_equal(_cat(ranks, n, "a2a/dx", 1),
                                  np.asarray(dx))
    # sequence-sharded in, head-sharded out: y is x, resharded
    np.testing.assert_array_equal(_cat(ranks, n, "a2a/y", 2), inp["a2a_x"])


def test_long_context_example_matches_dense():
    """``python -m kungfu_tpu_torch.examples.long_context_ring_attention
    --world 2 --device cpu``: ring, Ulysses and ring-flash against dense
    attention over the whole sequence."""
    import subprocess
    r = subprocess.run(
        [sys.executable, "-m",
         "kungfu_tpu_torch.examples.long_context_ring_attention", "--world",
         "2", "--device", "cpu"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    errs = {line.split()[0]: float(line.rsplit("=", 1)[1])
            for line in r.stdout.splitlines() if "max err" in line}
    assert set(errs) == {"ring", "ulysses", "ring_flash"}, r.stdout
    assert max(errs.values()) < 1e-5, errs
