"""The port's ResNet and its train step against the JAX package's, on the
CPU.

The same variables go to both sides: the port's module draws them from a
seed (``ResNet.init``), the BatchNorm scales, biases and running
statistics are then perturbed with numpy (so that every block's last
BatchNorm, which starts at scale 0, lets its branch through, and the
running statistics matter in eval mode), and ``flax_variables`` hands
the tree to flax; images are ``RandomState`` NHWC arrays, given to the
port as an NCHW channels-last view.

Tolerances, all f32 unless stated: logits within 1e-4 of max |logit|
(measured 2e-7 on the small model, 1.2e-5 on ResNet-50 at 2 x 64 x 64,
where flax is itself 1.4e-5 and the port 2.6e-6 from a float64 run of
the port: flax's variance, E[x^2] - E[x]^2, loses digits that torch's
does not); BatchNorm statistics within 1e-4 x max(1, |stat|) per leaf.
A planted fault (symmetric padding where flax pads (0, 1), or torch's
unbiased running variance) moves the logits or the statistics by more
than 10x these limits (checked below), so the limits see both traps.

Train step (3 steps of SGD 0.1, momentum 0.9, nesterov, as bench.py):
losses within 1e-5 relative, parameters within 1e-4 absolute and
statistics as above (BatchNorm over a batch of 8 amplifies the
summation-order noise of f32 gradients a little).  bf16, as the model
dtype or as the step's compute dtype: losses within 2e-2 (measured
7e-3), and the parameters (L2 and max distance) and the statistics (L2)
no farther from JAX's bf16 run than twice the distance of JAX's own
bf16 run from its f32 run (measured 1.3x, 1.2x and 1.5x): bf16
activations round differently in the two frameworks, and three SGD steps
on BatchNorm over a batch of 8 carry that noise into the weights as far
as bf16 itself carries them from f32.
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
import torch.nn.functional as F

import kungfu_tpu.optimizers as kfopt
from kungfu_tpu.comm.mesh import flat_mesh as jflat_mesh
from kungfu_tpu.models import resnet as JR
from kungfu_tpu.training import (build_train_step_with_state as jbuild,
                                 init_opt_state, replicate)
from kungfu_tpu_torch.benchmarks import resnet as BR
from kungfu_tpu_torch.benchmarks.gpt import solo_group
from kungfu_tpu_torch.comm.mesh import flat_mesh
from kungfu_tpu_torch.convert import flax_variables, load_flax_variables
from kungfu_tpu_torch.models import resnet as TR
from kungfu_tpu_torch.optimizers import synchronous_sgd
from kungfu_tpu_torch.training import build_train_step_with_state

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LOGIT_TOL, STAT_TOL = 1e-4, 1e-4
SMALL = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)


def perturbed_variables(model, seed=0):
    """``model``'s seeded weights with BatchNorm scales, biases and
    statistics moved off their initial values, loaded back into
    ``model``; returns the flax tree."""
    rng = np.random.RandomState(seed)
    v = flax_variables(model)

    def walk(node, coll, name=""):
        for k, a in node.items():
            if isinstance(a, dict):
                walk(a, coll, k)
            elif coll == "batch_stats" and k == "var":
                node[k] = (0.5 + rng.rand(*a.shape)).astype(np.float32)
            elif coll == "batch_stats" or k == "bias":
                node[k] = (0.1 * rng.randn(*a.shape)).astype(np.float32)
            elif k == "scale":
                # a block's last scale starts at 0: small, not 0
                base = 0.0 if name == "BatchNorm_2" else 1.0
                node[k] = (base + 0.2 * rng.randn(*a.shape)).astype(
                    np.float32)
    walk(v["params"], "params")
    walk(v["batch_stats"], "batch_stats")
    load_flax_variables(model, v)
    return v


def _images(B, img, seed=1):
    x = np.random.RandomState(seed).rand(B, img, img, 3).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def stat_excess(got, want, tol):
    """Largest |got - want| / (tol x max(1, |want|)) over the leaves."""
    return max(float(np.abs(g - w).max() / (tol * max(1.0, np.abs(w).max())))
               for g, w in zip(_leaves(got), _leaves(want)))


def forward_errors(jm, tm, v, x, xt) -> dict:
    """Eval and train logits and the updated statistics of the port
    against flax, each as a multiple of its limit (> 1 fails)."""
    tm.eval()
    with torch.no_grad():
        le = tm(xt).numpy()
    tm.train()
    with torch.no_grad():
        lt = tm(xt).numpy()
    je = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    jt, upd = jm.apply(v, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    jt = np.asarray(jt)
    rel = lambda got, want: float(np.abs(got - want).max()
                                  / (LOGIT_TOL * np.abs(want).max()))
    return {"eval": rel(le, je), "train": rel(lt, jt),
            "stats": stat_excess(flax_variables(tm)["batch_stats"],
                                 upd["batch_stats"], STAT_TOL)}


@pytest.mark.parametrize("small_inputs", [True, False],
                         ids=["cifar-stem", "imagenet-stem"])
@pytest.mark.parametrize("img", [16, 17], ids=["even", "odd"])
def test_small_resnet_matches_flax(small_inputs, img):
    tm = TR.ResNet(**SMALL, dtype=torch.float32, small_inputs=small_inputs)
    v = perturbed_variables(tm.init(3))
    jm = JR.ResNet(**SMALL, dtype=jnp.float32, small_inputs=small_inputs)
    errs = forward_errors(jm, tm, v, *_images(4, img))
    assert max(errs.values()) <= 1, errs


def test_resnet50_full_width_and_depth_matches_flax():
    tm = TR.ResNet50(num_classes=1000, dtype=torch.float32)
    assert sum(p.numel() for p in tm.parameters()) == 25_557_032
    assert sum(b.numel() for b in tm.buffers()) == 53_120
    assert tm.forward_flops(224, 224) == 8_178_368_512
    v = perturbed_variables(tm.init(0))
    jm = JR.ResNet50(num_classes=1000, dtype=jnp.float32)
    errs = forward_errors(jm, tm, v, *_images(2, 64))
    assert max(errs.values()) <= 1, errs


@pytest.mark.parametrize("depth", [101, 152])
def test_deeper_resnets_take_flax_trees(depth):
    """ResNet-101/152 (CPU only): the converter accepts flax's variables,
    every key and shape, from an abstract init."""
    jm = {101: JR.ResNet101, 152: JR.ResNet152}[depth]()
    tm = {101: TR.ResNet101, 152: TR.ResNet152}[depth]()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3))))
    load_flax_variables(tm, jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    assert sum(p.numel() for p in tm.parameters()) == {
        101: 44_549_160, 152: 60_192_808}[depth]


def _unbiased_running_var(self, x):
    """nn.BatchNorm2d's update: the unbiased variance blended in."""
    return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                        self.bias, self.training, 1 - self.momentum,
                        self.eps)


@pytest.mark.parametrize("fault", ["symmetric-padding", "unbiased-var"])
def test_planted_faults_fail_the_comparison(monkeypatch, fault):
    """What Conv2d(padding=1) / MaxPool2d(padding=1) and BatchNorm2d would
    compute: each fails the limits that the port passes."""
    tm = TR.ResNet(**SMALL, dtype=torch.float32)
    v = perturbed_variables(tm.init(3))
    jm = JR.ResNet(**SMALL, dtype=jnp.float32)
    x, xt = _images(4, 16)
    assert max(forward_errors(jm, tm, v, x, xt).values()) <= 1
    load_flax_variables(tm, v)
    if fault == "symmetric-padding":
        monkeypatch.setattr(TR, "same_pads", lambda n, k, s: (k // 2,) * 2)
    else:
        monkeypatch.setattr(TR.BatchNorm, "forward", _unbiased_running_var)
    errs = forward_errors(jm, tm, v, x, xt)
    key = "train" if fault == "symmetric-padding" else "stats"
    assert errs[key] > 10, errs


def test_same_pads_are_lax_pads():
    pads = jax.lax.padtype_to_pads
    for n in (7, 8, 14, 17, 56, 112):
        for k, s in ((1, 1), (1, 2), (3, 1), (3, 2), (7, 2)):
            assert TR.same_pads(n, k, s) == tuple(
                pads((n,), (k,), (s,), "SAME")[0]), (n, k, s)


def test_converter_is_strict():
    tm = TR.ResNet(**SMALL, dtype=torch.float32)
    v = flax_variables(tm)
    del v["params"]["bn_init"]["scale"]
    with pytest.raises(ValueError, match="missing.*bn_init/scale"):
        load_flax_variables(tm, v)
    v = flax_variables(tm)
    v["batch_stats"]["bn_init"]["extra"] = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="unexpected.*bn_init/extra"):
        load_flax_variables(tm, v)
    v = flax_variables(tm)
    v["params"]["Dense_0"]["kernel"] = v["params"]["Dense_0"]["kernel"].T
    with pytest.raises(ValueError, match="Dense_0/kernel: shape"):
        load_flax_variables(tm, v)
    assert "num_batches_tracked" not in dict(tm.named_buffers())


# ------------------------------------------------------------ train step
LR, STEPS = 0.1, 3


def _batch(B=8, img=16, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, img, img, 3).astype(np.float32)
    return x, rng.randint(0, 10, size=B).astype(np.int32)


def _jax_train(jm, v, x, y, n=1, accum=1, steps=STEPS, compute_dtype=None):
    def loss_fn(p, ms, batch):
        bx, by = batch
        logits, upd = jm.apply({"params": p, "batch_stats": ms}, bx,
                               train=True, mutable=["batch_stats"])
        return (optax.softmax_cross_entropy_with_integer_labels(
            logits, by).mean(), upd["batch_stats"])

    mesh = jflat_mesh(n=n)
    opt = kfopt.synchronous_sgd(optax.sgd(LR, momentum=0.9, nesterov=True))
    sp, sms = replicate(v["params"], mesh), replicate(v["batch_stats"], mesh)
    st = init_opt_state(opt, sp, mesh)
    step = jbuild(loss_fn, opt, mesh, donate=False, accum_steps=accum,
                  compute_dtype=compute_dtype)
    losses = []
    for _ in range(steps):
        sp, st, sms, loss = step(sp, st, sms,
                                 (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(np.asarray(loss)[0]))
    lanes = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return losses, lanes(sp), lanes(sms)


def _torch_train(tm, x, y, accum=1, steps=STEPS, compute_dtype=None):
    group = flat_mesh()
    params = dict(tm.named_parameters())
    state = dict(tm.named_buffers())
    opt = synchronous_sgd(torch.optim.SGD(params.values(), lr=LR,
                                          momentum=0.9, nesterov=True),
                          group)
    step = build_train_step_with_state(BR.make_loss_fn(tm), opt, params,
                                       state, group, accum_steps=accum,
                                       compute_dtype=compute_dtype)
    batch = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y))
    tm.train()
    return [float(step(batch)) for _ in range(steps)]


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax_f32(accum):
    tm = TR.ResNet(**SMALL, dtype=torch.float32)
    v = perturbed_variables(tm.init(4))
    jm = JR.ResNet(**SMALL, dtype=jnp.float32)
    x, y = _batch()
    jl, jp, js = _jax_train(jm, v, x, y, accum=accum)
    with solo_group(CPU):
        tl = _torch_train(tm, x, y, accum=accum)
    got = flax_variables(tm)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for g, w in zip(_leaves(got["params"]), _leaves(jp)):
        np.testing.assert_allclose(g, w[0], rtol=0, atol=1e-4)
    assert stat_excess(got["batch_stats"],
                       jax.tree_util.tree_map(lambda t: t[0], js),
                       STAT_TOL) <= 1
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert abs(tl[-1] - tl[0]) > 1e-3              # the steps did train


@pytest.mark.parametrize("where", ["model-dtype", "compute-dtype"])
def test_train_steps_match_jax_bf16(where):
    """bf16 as the model's dtype (bench.py's way: f32 parameters cast at
    each use) or as the step's ``compute_dtype`` (an f32 model, its
    parameters cast once a step): held against the spread bf16 itself
    causes, JAX's own bf16 run against its f32 run."""
    model_bf16 = where == "model-dtype"
    cdt = (None, None) if model_bf16 else (jnp.bfloat16, torch.bfloat16)
    tm = TR.ResNet(**SMALL, dtype=torch.bfloat16 if model_bf16
                   else torch.float32)
    v = perturbed_variables(tm.init(4))
    init = _flat_leaves(v["params"])
    x, y = _batch()
    jm = JR.ResNet(**SMALL, dtype=jnp.bfloat16 if model_bf16
                   else jnp.float32)
    jl, jp, js = _jax_train(jm, v, x, y, compute_dtype=cdt[0])
    _, fp, fs = _jax_train(JR.ResNet(**SMALL, dtype=jnp.float32), v, x, y)
    with solo_group(CPU):
        tl = _torch_train(tm, x, y, compute_dtype=cdt[1])
    got = flax_variables(tm)
    np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)
    lane0 = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)
    g, w, f = (_flat_leaves(got["params"]), _flat_leaves(lane0(jp)),
               _flat_leaves(lane0(fp)))
    assert np.linalg.norm(g - w) <= 2 * np.linalg.norm(w - f)
    assert np.abs(g - w).max() <= 2 * np.abs(w - f).max()
    assert np.linalg.norm(w - init) > 2 * np.linalg.norm(g - w)  # it moved
    gs, ws, fs = (_flat_leaves(got["batch_stats"]), _flat_leaves(lane0(js)),
                  _flat_leaves(lane0(fs)))
    assert np.linalg.norm(gs - ws) <= 2 * np.linalg.norm(ws - fs)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for b in tm.buffers())


def _flat_leaves(tree):
    return np.concatenate([a.reshape(-1) for a in _leaves(tree)])


# ------------------------------------------------------------- two ranks
WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from kungfu_tpu_torch.benchmarks import resnet as BR
    from kungfu_tpu_torch.comm.mesh import flat_mesh, init_process_group_file
    from kungfu_tpu_torch.convert import flax_variables, load_flax_variables
    from kungfu_tpu_torch.data.pipeline import prefetch_to_mesh
    from kungfu_tpu_torch.models.resnet import ResNet
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.training import (broadcast_variables,
                                           build_train_step_with_state)

    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    init_process_group_file(store, rank, 2, "gloo")
    group = flat_mesh(n=2)
    d = np.load(inp, allow_pickle=True)
    tm = ResNet([1, 1], 10, 8, torch.float32).init(rank)
    if rank == 0:
        load_flax_variables(tm, d["v"].item())
    params, state = dict(tm.named_parameters()), dict(tm.named_buffers())
    broadcast_variables(params, group)        # rank 1 starts elsewhere
    broadcast_variables(state, group)
    opt = synchronous_sgd(torch.optim.SGD(params.values(), lr=0.1,
                                          momentum=0.9, nesterov=True),
                          group)
    step = build_train_step_with_state(BR.make_loss_fn(tm), opt, params,
                                       state, group)
    # the global NCHW batch; the prefetcher stages this rank's block
    x = d["x"].transpose(0, 3, 1, 2)
    batches = [(x, d["y"])] * 3
    losses = []
    with prefetch_to_mesh(iter(batches), group, depth=2,
                          device="cpu") as pf:
        for bx, by in pf:
            assert bx.shape[0] == x.shape[0] // 2
            losses.append(float(step((bx, by), local=True)))
    v = flax_variables(tm)
    np.savez(out, losses=np.array(losses),
             **{"p/" + "/".join(k): a for k, a in _flat(v["params"])},
             **{"s/" + "/".join(k): a for k, a in _flat(v["batch_stats"])})
""")
FLAT = textwrap.dedent("""
    def _flat(tree, prefix=()):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from _flat(tree[k], prefix + (k,))
            else:
                yield prefix + (k,), tree[k]
""")


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def test_two_rank_step_with_state_matches_jax(tmp_path):
    """Two processes meet through a FileStore (no TCP port).  Each rank
    normalises with its own half of the batch; the averaged running
    statistics and the replicas must match JAX on two lanes."""
    tm = TR.ResNet(**SMALL, dtype=torch.float32)
    v = perturbed_variables(tm.init(5))
    x, y = _batch()
    np.savez(tmp_path / "in.npz", v=np.array(v, dtype=object), x=x, y=y)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    code = FLAT + WORKER
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(tmp_path / "store"),
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
    for k in r0.files:                        # identical replicas
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    jm = JR.ResNet(**SMALL, dtype=jnp.float32)
    jl, jp, js = _jax_train(jm, v, x, y, n=2)
    # JAX's lanes agree with each other too, after the state average
    for a in _leaves(js):
        np.testing.assert_allclose(a[0], a[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5, atol=1e-5)
    for key, w in _flat(jax.tree_util.tree_map(lambda t: t[0], jp)):
        np.testing.assert_allclose(r0["p/" + "/".join(key)], w, rtol=0,
                                   atol=1e-4, err_msg=str(key))
    for key, w in _flat(jax.tree_util.tree_map(lambda t: t[0], js)):
        g = r0["s/" + "/".join(key)]
        assert np.abs(g - w).max() <= STAT_TOL * max(1, np.abs(w).max()), \
            key


# -------------------------------------------------- the benchmark entry
SMALL_ARGS = ["--device", "cpu", "--stage-sizes", "1,1", "--num-filters",
              "8", "--num-classes", "10", "--image-size", "16", "--f32",
              "--batch", "4", "--iters", "2", "--warmup", "1"]


def test_benchmark_runs_on_cpu_and_prints_one_json_line(capsys):
    import json
    assert BR.main(SMALL_ARGS) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == \
        "cpu_resnet1-1_f8_c10_i16_f32_images_per_sec"
    assert not any(k.startswith("resnet50") for k in out)
    assert "vs_baseline" not in out and "peak_memory_gb" not in out
    assert out["backend"] == "cpu" and out["device"] == "cpu"
    assert out["value"] > 0
    assert np.isfinite([out["loss_first"], out["loss_last"]]).all()
    assert BR.model_tag(BR.parse_args([])) == "resnet50"
    assert BR.model_tag(BR.parse_args(["--f32"])) != "resnet50"


def test_benchmark_defaults_to_the_card():
    """Without --device the entry point asks for cuda and raises when
    there is none; it never falls back to the CPU or a smaller model."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BR.main(["--iters", "1"])
