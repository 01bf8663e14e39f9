"""The port's simple models and BERT against the flax models, on the CPU.

Variables come from flax's ``init`` (seeded), go to the port through
``load_flax_variables`` and come back unchanged through
``flax_variables``; inputs are ``RandomState`` arrays (NHWC images,
given to the port as an NCHW view).

Tolerances: f32 outputs within 1e-5 of max |output| (measured up to
3e-6: reduction order); bf16 (VGG16, BERT) within 2e-2 of max |output|
(measured 5e-3 and 6e-3: bf16 activations round at other places in the
two frameworks).  ``bert_tiny`` trains 2 steps of synchronous-SGD Adam
1e-3 under ``build_train_step`` as tests/test_end_to_end.py trains the
flax model: losses within 1e-5, parameters within 1e-5 absolute, but
for the key part of the fused qkv bias, whose exact gradient is 0 (it
shifts a query's logits alike) and which Adam, dividing by sqrt(v),
moves by about +-lr a step on rounding noise in either framework: it
may move at most lr a step from its start.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kungfu_tpu.optimizers as kfopt
from kungfu_tpu.comm.mesh import flat_mesh as jflat_mesh
from kungfu_tpu.models import bert as JB
from kungfu_tpu.models import simple as JS
from kungfu_tpu.training import build_train_step as jbuild
from kungfu_tpu.training import init_opt_state, replicate
from kungfu_tpu_torch.benchmarks.gpt import solo_group
from kungfu_tpu_torch.comm.mesh import flat_mesh
from kungfu_tpu_torch.convert import flax_variables, load_flax_variables
from kungfu_tpu_torch.models import bert as TB
from kungfu_tpu_torch.models import simple as TS
from kungfu_tpu_torch.optimizers import synchronous_sgd
from kungfu_tpu_torch.training import build_train_step
from kungfu_tpu_torch.utils.tree import tree_leaves


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_tree(got, want):
    g, w = jax.tree_util.tree_flatten(got), jax.tree_util.tree_flatten(want)
    assert g[1] == w[1]
    for a, b in zip(g[0], w[0]):
        np.testing.assert_array_equal(a, b)


def _compare(jm, tm, jin, tin, tol, **kw):
    v = _np(jm.init(jax.random.PRNGKey(0), *jin))
    load_flax_variables(tm, v)
    _same_tree(flax_variables(tm), v)
    want = np.asarray(jm.apply(v, *jin, **kw), np.float32)
    with torch.no_grad():
        got = tm(*tin).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    return got


def _images(B, side, c, seed=0):
    x = np.random.RandomState(seed).rand(B, side, side, c).astype(
        np.float32)
    return (jnp.asarray(x),), (torch.from_numpy(x).permute(0, 3, 1, 2),)


@pytest.mark.parametrize("name", ["slp", "mlp"])
def test_mnist_models_match_flax(name):
    jm, tm = {"slp": (JS.MnistSLP(), TS.MnistSLP()),
              "mlp": (JS.MnistMLP(), TS.MnistMLP())}[name]
    _compare(jm, tm, *_images(4, 28, 1), 1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vgg16_matches_flax(dtype):
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 1e-5),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dtype]
    jm = JS.VGG16(num_classes=10, dtype=jdt)
    tm = TS.VGG16(num_classes=10, dtype=tdt, image_size=32)
    got = _compare(jm, tm, *_images(2, 32, 3), tol)
    assert tm(_images(2, 32, 3)[1][0]).dtype == torch.float32   # f32 head
    assert np.isfinite(got).all()


def test_vgg_flattens_in_nhwc_order():
    """The first Dense sees (h, w, c)-ordered features, as flax's NHWC
    reshape gives them: at 64 x 64 the conv stack ends at 2 x 2, so a
    (c, h, w) flatten would permute the Dense's rows."""
    jm = JS.VGG(cfg=(8, "M", 8, "M", 8, "M", 8, "M", 8, "M"), num_classes=4,
                dtype=jnp.float32)
    tm = TS.VGG(cfg=(8, "M", 8, "M", 8, "M", 8, "M", 8, "M"), num_classes=4,
                dtype=torch.float32, image_size=64)
    _compare(jm, tm, *_images(2, 64, 3), 1e-5)
    assert TS.VGG19(num_classes=4, dtype=torch.float32,
                    image_size=32).Conv_15.out_channels == 512


def _tokens(B=2, S=16, V=1024, seed=1):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[1, 10:] = False                    # padded tail in row 1
    return toks, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bert_tiny_matches_flax(dtype):
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 1e-5),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dtype]
    toks, mask = _tokens()
    jm, tm = JB.bert_tiny(dtype=jdt), TB.bert_tiny(dtype=tdt)
    got = _compare(jm, tm, (jnp.asarray(toks), jnp.asarray(mask)),
                   (torch.from_numpy(toks), torch.from_numpy(mask)), tol)
    assert got.shape == (2, 16, 1024)
    with torch.no_grad():                   # the mask is honoured
        unmasked = tm(torch.from_numpy(toks)).numpy()
    assert np.abs(unmasked[1] - got[1]).max() > 1e-3
    np.testing.assert_allclose(unmasked[0], got[0], rtol=1e-6, atol=1e-6)


def test_bert_defaults_are_flax_defaults():
    tm = TB.bert_tiny(dtype=torch.float32)
    assert tm.LayerNorm_0.eps == 1e-6
    assert tm.EncoderLayer_0.LayerNorm_1.eps == 1e-6
    base = TB.bert_base()
    assert base.dtype == torch.bfloat16 and base.num_layers == 12
    assert sum(p.numel() for p in base.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda: JB.bert_base().init(
                jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))))
    g = TB.bert_tiny(dtype=torch.float32).init(0)
    assert abs(float(g.pos_emb.detach().std()) - 0.02) < 2e-3


def test_bert_tiny_trains_like_jax():
    """tests/test_end_to_end.py's bert_tiny run (Adam 1e-3, predict the
    input token), 2 steps, one rank."""
    kw = dict(num_layers=1, hidden=32, num_heads=2, mlp_dim=64,
              vocab_size=128, max_len=16)
    jm = JB.bert_tiny(dtype=jnp.float32, **kw)
    tm = TB.bert_tiny(dtype=torch.float32, **kw)
    tokens = np.random.RandomState(0).randint(0, 128, (4, 16))
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:2])))
    load_flax_variables(tm, v)

    def jloss(p, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply({"params": p}, batch), batch).mean()

    opt = kfopt.synchronous_sgd(optax.adam(1e-3))
    mesh = jflat_mesh(n=1)
    sp = replicate(v["params"], mesh)
    st = init_opt_state(opt, sp, mesh)
    jstep = jbuild(jloss, opt, mesh, donate=False)
    jl = []
    for _ in range(2):
        sp, st, loss = jstep(sp, st, jnp.asarray(tokens))
        jl.append(float(np.asarray(loss)[0]))

    def tloss(p, batch):
        logits = torch.func.functional_call(tm, p, (batch,))
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), batch.reshape(-1).long())

    params = dict(tm.named_parameters())
    with solo_group(torch.device("cpu")):
        topt = synchronous_sgd(torch.optim.Adam(
            tree_leaves(params), lr=1e-3, betas=(0.9, 0.999), eps=1e-8),
            flat_mesh())
        step = build_train_step(tloss, topt, params)
        tl = [float(step(torch.from_numpy(tokens))) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    assert tl[1] < tl[0]
    got = flax_variables(tm)["params"]
    want = jax.tree_util.tree_map(lambda t: np.asarray(t)[0], sp)
    # the key bias shifts every logit of a query row alike, so its exact
    # gradient is 0 and Adam steps it by about +-lr on rounding noise
    qkv = ("EncoderLayer_0", "MultiHeadAttention_0", "qkv", "bias")
    gb, wb = (np.array(t[qkv[0]][qkv[1]][qkv[2]].pop(qkv[3]))
              for t in (got, want))
    key = slice(kw["hidden"], 2 * kw["hidden"])
    assert np.abs(gb[key] - v["params"][qkv[0]][qkv[1]][qkv[2]][qkv[3]][
        key]).max() <= 2 * 1e-3 * 1.01
    gb[key] = wb[key] = 0
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
