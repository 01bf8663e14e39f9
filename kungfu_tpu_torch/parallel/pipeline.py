"""Pipeline parallelism (dp x pp, optionally x tp) for the GPT model family
(counterpart of kungfu_tpu/parallel/pipeline.py).

The layer stack is stacked (one tensor per leaf, leading axis = layer) and
split over the ``pp`` ranks: each stage holds a contiguous block of
layers, and microbatches flow stage -> stage + 1.  ``virtual_stages=v >
1`` runs the Megatron-style interleaved schedule: rank r holds the v
layer chunks r, r + S, ..., r + (v - 1) S (the stacked axis permuted by
:func:`interleave_layer_order`), ticks shrink to one chunk, and the
bubble drops to 1 + (S - 1) / (v M) at v x the hand-offs.

The schedule is written out.  JAX runs the forward ticks in one
``lax.scan`` and gets the backward pipeline from AD's transpose of it,
bubble ticks computing garbage that masks drop.  Torch's autograd runs a
reverse transfer only for a tick whose output reached the loss, in an
order the engine chooses, so :func:`make_gpt_pp_train_step` runs the
:func:`pp_schedule_ticks` forward ticks (each unit decoded to (chunk,
microbatch) as JAX decodes it), keeping each unit's input and, unless
``remat``, its graph; the LM head and loss on the last stage's M
outputs, one microbatch at a time; and the ticks again in reverse, where
each rank takes dy from rank r + 1, backpropagates its unit and sends dx
to rank r.  Every rank issues every hand-off of every tick
(``comm.collectives.stage_handoff``: an open chain at v = 1, a ring at
v > 1), zeros where it has no unit; a rank skips a bubble unit's compute,
which JAX computes and masks (the values are the same).

The gradient rule.  ``wte`` (and ``wpe``) is used on stage 0 only, ``lnf``
and ``lm_head`` on stage S - 1 only: the other ranks' gradients of them
are zero, and one sum over the (dp, pp) group restores the totals, where
JAX's AD psums them.  The layer stack's gradients are summed over dp.
Under tp the model's Megatron pair (``copy_to_group``,
``reduce_from_group``) already leaves a replicated leaf's gradient whole
on every tp rank, as in ``threed``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import ops
from ..comm import collectives as C
from ..comm.mesh import ProcessMesh, make_mesh, shard_tree
from ..models import gpt as G
from ..training import _update
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves

DP_AXIS, PP_AXIS, TP_AXIS = "dp", "pp", "tp"


def mesh_dp_pp(dp: int, pp: int,
               timeout_s: Optional[float] = None) -> Optional[ProcessMesh]:
    """The (dp, pp) mesh over the first dp * pp ranks with the dp, pp and
    (dp, pp) groups.  Collective, as ``comm.mesh.make_mesh``."""
    return make_mesh((DP_AXIS, PP_AXIS), (dp, pp),
                     groups=((DP_AXIS,), (PP_AXIS,), (DP_AXIS, PP_AXIS)),
                     timeout_s=timeout_s)


def mesh_dp_pp_tp(dp: int, pp: int, tp: int,
                  timeout_s: Optional[float] = None
                  ) -> Optional[ProcessMesh]:
    """Megatron-style 3D: data x pipeline x tensor, tp innermost (rank =
    (d * pp + s) * tp + t), with the dp, pp, tp and (dp, pp) groups."""
    return make_mesh((DP_AXIS, PP_AXIS, TP_AXIS), (dp, pp, tp),
                     groups=((DP_AXIS,), (PP_AXIS,), (TP_AXIS,),
                             (DP_AXIS, PP_AXIS)),
                     timeout_s=timeout_s)


def stack_layers(params):
    """[L x layer-dict] -> one dict with a leading layer axis per leaf,
    so the layer stack splits over pp with a plain leading-axis split."""
    layers = params["layers"]
    out = dict(params)
    out["layers"] = {k: torch.stack([layer[k] for layer in layers])
                     for k in layers[0]}
    return out


def unstack_layers(params, n_layers: int):
    """Inverse of :func:`stack_layers` (e.g. for the one-process oracle)."""
    stacked = params["layers"]
    out = dict(params)
    out["layers"] = [{k: t[i] for k, t in stacked.items()}
                     for i in range(n_layers)]
    return out


def pp_schedule_ticks(S: int, M: int, v: int = 1) -> int:
    """Exact tick count of the schedule: the last unit is (chunk S*v-1,
    microbatch M-1), which runs at tick e(M-1) + S*v - 1 with entry
    schedule e(m) = (m//S)*v*S + m%S.  Equals v*M + S - 1 when M is a
    multiple of S (the Megatron formula) and reduces to the GPipe
    S + M - 1 at v=1; for M < S it is (M-1) + S*v."""
    return ((M - 1) // S) * v * S + (M - 1) % S + S * v


def interleave_layer_order(n_layers: int, S: int, v: int):
    """Layer permutation for interleaved virtual stages: global chunk
    ``c`` (of ``S*v``) lives on rank ``c % S`` as its ``c // S``-th local
    chunk, so each rank's contiguous pp block of the permuted stack holds
    exactly its v chunks in local chunk order.  ``numpy`` array of layer
    indices."""
    if n_layers % (S * v):
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{S} pipeline stages x {v} virtual stages")
    Lc = n_layers // (S * v)
    order = []
    for r in range(S):
        for j in range(v):
            c = r + j * S
            order.extend(range(c * Lc, (c + 1) * Lc))
    return np.asarray(order, dtype=np.int64)


def _permute_layers(params, order):
    out = dict(params)
    idx = torch.as_tensor(order)
    out["layers"] = {k: t[idx.to(t.device)]
                     for k, t in params["layers"].items()}
    return out


def interleave_params(params, n_layers: int, S: int, v: int):
    """A stacked tree (:func:`stack_layers`) in the interleaved order
    (:func:`interleave_layer_order`; v = 1 leaves it as it is): what
    :func:`init_gpt_pp` shards, and the pipeline form of a tree carried
    over from JAX (``convert.params_from_jax``, then
    :func:`stack_layers`, then this)."""
    if v == 1:
        return params
    return _permute_layers(params, interleave_layer_order(n_layers, S, v))


def deinterleave_params(params, n_layers: int, S: int, v: int):
    """Undo :func:`interleave_params`, so interleaved-trained parameters
    compare leaf for leaf with the natural layer order."""
    order = interleave_layer_order(n_layers, S, v)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return _permute_layers(params, inv)


def pp_param_specs(cfg: G.GPTConfig, tp: Optional[str] = None) -> dict:
    """The mesh axis each dimension of a stacked leaf splits over
    (``comm.mesh.shard_tree``'s specs; JAX's ``PartitionSpec`` tree less
    its trailing Nones): the layer stack over pp on its leading axis,
    and under ``tp`` each layer's heads and FFN features and the LM
    head's vocabulary as ``models.gpt.param_specs`` says.  The
    embeddings and the final norm stay replicated."""
    dims = G.param_specs(cfg)

    def on_tp(d):
        return () if d is None or tp is None else (None,) * d + (tp,)
    out = {"wte": (), "lnf": (), "lm_head": on_tp(dims["lm_head"]),
           "layers": {k: (PP_AXIS,) + on_tp(None if d is None else d)
                      for k, d in dims["layers"][0].items()}}
    if not cfg.rope:
        out["wpe"] = ()
    return out


def _tp(mesh: Optional[ProcessMesh]) -> Optional[str]:
    return TP_AXIS if mesh is not None and TP_AXIS in mesh.axis_names \
        else None


def shard_params(params, cfg: G.GPTConfig, mesh: Optional[ProcessMesh]):
    """This rank's block of a stacked (and, for v > 1, interleaved) full
    tree, as new tensors: its pp block of the layer stack and its tp
    slices (:func:`pp_param_specs`), the whole of a replicated leaf."""
    return shard_tree(params, pp_param_specs(cfg, _tp(mesh)), mesh)


def init_gpt_pp(cfg: G.GPTConfig, mesh: ProcessMesh, seed: int = 0,
                device=None, virtual_stages: int = 1):
    """This rank's f32 parameter blocks, from the full tree drawn from
    ``torch.Generator(device).manual_seed(seed)`` (the same on every
    rank), stacked, interleaved for ``virtual_stages`` > 1 and sharded.
    Build the optimizer on ``tree_leaves`` of the result."""
    device = resolve_device(device)
    full = G.init_params(torch.Generator(device=device).manual_seed(seed),
                         cfg)
    tree = interleave_params(stack_layers(full), cfg.n_layers,
                             mesh.size(PP_AXIS), virtual_stages)
    del full
    return shard_params(tree, cfg, mesh)


def _stage_forward(layers, x, cfg: G.GPTConfig, tp_group=None, pos=None,
                   attn: str = "dense"):
    """Apply a stage's (or chunk's) layers, a list of layer dicts, in
    order.  ``attn``: "flash" (K1-K4 on a CUDA tensor) or "dense"."""
    for layer in layers:
        x = G.apply_layer(layer, x, cfg, attn=attn, pos=pos,
                          tp_group=tp_group)
    return x


def _unit(t: int, stage: int, S: int, M: int, v: int):
    """This rank's unit at tick ``t``, as (local chunk j, microbatch m),
    or None in a bubble: t - stage = q*(v*S) + j*S + s with m = q*S + s
    (JAX's decode)."""
    if t < stage:
        return None
    a = t - stage
    b = a // S
    m = (b // v) * S + a % S
    return (b % v, m) if m < M else None


def _forward_unit(fn, x_in, remat: bool):
    """A unit's forward; its graph is kept unless ``remat``."""
    if remat:
        with torch.no_grad():
            return fn(x_in)
    return fn(x_in)


def _backward_unit(fn, x_in, y, dy, inputs, remat: bool):
    """A unit's backward: the gradients of ``inputs`` (its input first,
    when it takes an activation) at cotangent ``dy``; under ``remat`` its
    forward runs again first."""
    if remat:
        y = fn(x_in)
    return torch.autograd.grad(y, inputs, dy, allow_unused=True)


def _sync_gradients(masters, layer_leaf, mesh: ProcessMesh) -> None:
    """Sum the layer stack's gradients over dp and every replicated
    leaf's (embeddings, final norm, head) over (dp, pp), one fused
    all-reduce each (the psums of JAX's AD; see the module docstring)."""
    for want, axes in ((True, (DP_AXIS,)), (False, (DP_AXIS, PP_AXIS))):
        if mesh.size(*axes) == 1:
            continue
        ms = [m for m, is_layer in zip(masters, layer_leaf)
              if is_layer == want]
        grads = ops.fused_all_reduce([m.grad for m in ms],
                                     mesh.group(*axes), "SUM")
        for m, g in zip(ms, grads):
            m.grad = g


def _validate(cfg: G.GPTConfig, mesh: ProcessMesh, v: int) -> None:
    S = mesh.size(PP_AXIS)
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    if cfg.n_layers % (S * v) != 0:
        raise ValueError(f"{cfg.n_layers} layers not divisible by "
                         f"{S} pipeline stages x {v} virtual stages")
    if _tp(mesh) is not None:
        ntp = mesh.size(TP_AXIS)
        for what, val in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                          ("vocab_size", cfg.vocab_size)):
            if val % ntp != 0:
                raise ValueError(f"{what}={val} not divisible by "
                                 f"{ntp} tensor-parallel ranks")
        G.validate_tp(cfg, ntp)


def make_gpt_pp_train_step(cfg: G.GPTConfig,
                           optimizer: torch.optim.Optimizer,
                           mesh: ProcessMesh, params, n_micro: int,
                           remat: bool = False, virtual_stages: int = 1,
                           compute_dtype=None) -> Callable:
    """``step(tokens, targets) -> loss`` with the layer stack pipelined
    over ``pp`` and the batch split over ``dp`` (and, on a (dp, pp, tp)
    mesh, Megatron tensor parallelism inside each stage).

    ``params``: this rank's blocks (:func:`init_gpt_pp` or
    :func:`shard_params`), the f32 masters that ``optimizer`` was built
    on; the step updates them in place.  ``tokens``/``targets``: the
    GLOBAL [B, T] int batch, the same on every rank; each dp rank takes
    its rows, which must divide into ``n_micro`` microbatches.  The loss
    is the global token-mean NLL, the same on every rank: the last
    stage's ``loss_sum / (B_local * T * dp)``, summed over (dp, pp).

    ``virtual_stages`` = v > 1: the interleaved schedule (the parameters
    interleaved by :func:`interleave_params`).  ``remat``: each unit
    keeps only its input, and its forward runs again in the backward
    (the flash forward then runs twice a unit).  The stages attend
    through the flash kernels K1-K4 on a CUDA batch, densely on a CPU one
    (``models.gpt.auto_attn``).  ``compute_dtype``: mixed precision as
    in ``threed``; each leaf's gradient is accumulated over the units in
    f32 and reaches its f32 master rounded once."""
    v = virtual_stages
    _validate(cfg, mesh, v)
    S, dp, stage = mesh.size(PP_AXIS), mesh.size(DP_AXIS), \
        mesh.index(PP_AXIS)
    ntp = mesh.size(TP_AXIS) if _tp(mesh) else 1
    tp_group = mesh.group(TP_AXIS) if ntp > 1 else None
    pp_group = mesh.group(PP_AXIS)
    M, L = n_micro, cfg.n_layers // S
    Lc, ring = L // v, v > 1
    n_ticks = pp_schedule_ticks(S, M, v)
    masters = [t for t in tree_leaves(params) if t.is_floating_point()]
    layer_leaf = [k == "layers" for k in sorted(params)
                  for _ in tree_leaves(params[k])]

    def step(tokens, targets):
        Bg, T = tokens.shape
        if Bg % dp:
            raise ValueError(f"global batch {Bg} not divisible by dp {dp}")
        B = Bg // dp
        if B % M != 0:
            raise ValueError(f"local batch {B} not divisible by "
                             f"{M} microbatches")
        d, mb = mesh.index(DP_AXIS), B // M
        tok = tokens[d * B:(d + 1) * B]
        tgt = targets[d * B:(d + 1) * B]
        dev = tok.device
        mode = G.auto_attn(tok)
        total = B * T * dp
        pos = torch.arange(T, device=dev)
        with torch.no_grad():
            work = {k: (t.detach() if compute_dtype is None
                        else t.to(compute_dtype))
                    for k, t in params.items() if k != "layers"}
            stacked = {k: (t.detach() if compute_dtype is None
                           else t.to(compute_dtype))
                       for k, t in params["layers"].items()}
        for t in work.values():
            t.requires_grad_(True)
        layers = [{k: t[i].requires_grad_(True) for k, t in stacked.items()}
                  for i in range(L)]
        acc = {k: None for k in work}
        acc_layers = [{k: None for k in stacked} for _ in range(L)]

        def add(store, key, g):
            if g is not None:
                store[key] = g.float() if store[key] is None \
                    else store[key] + g.float()

        def unit_fn(j, embeds):
            chunk = layers[j * Lc:(j + 1) * Lc]

            def fn(x):
                if embeds:
                    x = G.embed(work, x, pos[None], cfg)
                return _stage_forward(chunk, x, cfg, tp_group, pos, mode)
            return fn

        # ---- forward ticks
        saved, finals = {}, {}
        x_buf = torch.zeros((mb, T, cfg.d_model), dtype=cfg.dtype,
                            device=dev)
        for t in range(n_ticks):
            u = _unit(t, stage, S, M, v)
            y_out = torch.zeros_like(x_buf)
            if u is not None:
                j, m = u
                embeds = stage == 0 and j == 0
                x_in = (tok[m * mb:(m + 1) * mb] if embeds
                        else x_buf.detach().requires_grad_(True))
                y = _forward_unit(unit_fn(j, embeds), x_in, remat)
                saved[u] = (x_in, None if remat else y)
                if stage == S - 1 and j == v - 1:
                    finals[m] = y.detach()
                y_out = y.detach()
            x_buf = C.stage_handoff(y_out, pp_group, 1, ring)

        # ---- the LM head and loss on the last stage, a microbatch at a
        # time (peak logits: one [mb, T, V / tp] tile)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        dys = {}
        if stage == S - 1:
            head = [work["lnf"], work["lm_head"]]
            for m in range(M):
                y = finals.pop(m).requires_grad_(True)
                xf = G.rms_norm(y, work["lnf"]).float()
                if tp_group is not None:
                    xf = C.copy_to_group(xf, tp_group)
                logits = torch.einsum("btd,dv->btv", xf,
                                      work["lm_head"].float())
                nll = G.parallel_cross_entropy(
                    logits, tgt[m * mb:(m + 1) * mb], tp_group).sum()
                loss = nll / total
                grads = torch.autograd.grad(loss, [y] + head)
                dys[m] = grads[0]
                add(acc, "lnf", grads[1])
                add(acc, "lm_head", grads[2])
                loss_sum += loss.detach().float()

        # ---- backward ticks, in reverse
        g_buf = torch.zeros_like(x_buf)
        for t in reversed(range(n_ticks)):
            u = _unit(t, stage, S, M, v)
            dx_out = torch.zeros_like(g_buf)
            if u is not None:
                j, m = u
                embeds = stage == 0 and j == 0
                dy = (dys.pop(m) if stage == S - 1 and j == v - 1
                      else g_buf)
                x_in, y = saved.pop(u)
                chunk = list(range(j * Lc, (j + 1) * Lc))
                leaves = [layers[i][k] for i in chunk for k in stacked]
                extra = ([work["wte"]] + ([work["wpe"]] if "wpe" in work
                                          else [])
                         if embeds else [x_in])
                grads = _backward_unit(unit_fn(j, embeds), x_in, y, dy,
                                       extra + leaves, remat)
                n = len(extra)
                if embeds:
                    for k, g in zip(("wte", "wpe"), grads[:n]):
                        add(acc, k, g)
                elif grads[0] is not None:
                    dx_out = grads[0].to(g_buf.dtype)
                it = iter(grads[n:])
                for i in chunk:
                    for k in stacked:
                        add(acc_layers[i], k, next(it))
            g_buf = C.stage_handoff(dx_out, pp_group, -1, ring)

        with torch.no_grad():
            full = dict(acc)
            full["layers"] = {k: torch.stack([
                acc_layers[i][k] if acc_layers[i][k] is not None
                else torch.zeros_like(stacked[k][i], dtype=torch.float32)
                for i in range(L)]) for k in stacked}
            ref = dict(work, layers=stacked)
            for mst, g, w in zip(masters, tree_leaves(full),
                                 tree_leaves(ref)):
                g = torch.zeros_like(w, dtype=torch.float32) if g is None \
                    else g
                mst.grad = g.to(w.dtype).to(mst.dtype)
        _sync_gradients(masters, layer_leaf, mesh)
        _update(optimizer, masters)
        if mesh.size(DP_AXIS, PP_AXIS) > 1:
            loss_sum = C.all_reduce(loss_sum, mesh.group(DP_AXIS, PP_AXIS),
                                    "SUM")
        return loss_sum

    return step
