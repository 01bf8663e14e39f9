"""3D-parallel (dp x sp x tp) training for the GPT model family
(counterpart of kungfu_tpu/parallel/threed.py).

- ``dp``: batch data parallelism; the gradients are summed over dp.
- ``sp``: sequence parallelism; ring, ring-flash or Ulysses attention
  shard the sequence, and every parameter's gradient is partial over sp
  too.
- ``tp``: tensor parallelism; heads, FFN features and the vocabulary are
  sharded, and activations are completed by all-reduces inside the model
  (``models/gpt.py``).  :func:`make_tp_generate` decodes over the same
  shards.

Each rank is a process that holds its slices of the parameters
(:func:`shard_params`, per ``models.gpt.param_specs``) as f32 leaf
tensors, and a ``torch.optim`` optimizer built on them: its state is
sharded as the parameters are, the counterpart of GSPMD carrying the
parameter shardings to the optax state.

The gradient rule.  JAX writes no gradient sync: ``shard_map``'s AD
returns each parameter's gradient in the parameter's own sharding.  The
port writes it.  The Megatron pair in the model (``copy_to_group`` where
a replicated activation enters a sharded product, ``reduce_from_group``
where partial products leave) sits where JAX's psums and their
transposes fall, so a replicated parameter's gradient is already whole
on every tp rank, and a sharded one's is its slice of the whole.  Both
are then partial sums over the rank's batch rows and sequence block: one
sum over the (dp, sp) group completes every gradient.  A second sum over
tp would count the replicated gradients tp times.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import ops
from ..comm import collectives as C
from ..comm.mesh import ProcessMesh, make_mesh
from ..models import gpt as G
from ..ops.quant import QuantizedTensor, quantize_specs
from ..training import _accum_grads_fn, _update
from ..utils.device import resolve_device
from ..utils.tree import tree_map
from . import SEQ_AXIS

DP_AXIS, SP_AXIS, TP_AXIS = "dp", SEQ_AXIS, "tp"


def mesh_3d(dp: int, sp: int, tp: int,
            timeout_s: Optional[float] = None) -> Optional[ProcessMesh]:
    """The (dp, sp, tp) mesh over the first dp * sp * tp ranks, tp
    innermost (rank = (d * sp + s) * tp + t, JAX's device order), with the
    dp, sp, tp and (dp, sp) groups.  Collective: every rank of the
    default group calls it; a rank past the mesh gets None.  The groups
    take the default group's backend (gloo for several ranks on one card:
    NCCL refuses two ranks on one device); give ``timeout_s`` so that a
    collective that never completes fails the run."""
    return make_mesh((DP_AXIS, SP_AXIS, TP_AXIS), (dp, sp, tp),
                     groups=((DP_AXIS,), (SP_AXIS,), (TP_AXIS,),
                             (DP_AXIS, SP_AXIS)),
                     timeout_s=timeout_s)


def shard_params(params, cfg: G.GPTConfig, mesh: Optional[ProcessMesh]):
    """This rank's slices of a full parameter tree, as new tensors: the
    tp rank's block of each dimension ``param_specs`` names, the whole of
    a replicated leaf.  An int8 leaf (``ops.quant.QuantizedTensor``, of
    the full tree) splits its q and its scale as ``quantize_specs``
    says."""
    ntp = mesh.size(TP_AXIS) if mesh is not None else 1
    t = mesh.index(TP_AXIS) if mesh is not None else 0
    G.validate_tp(cfg, ntp)

    def take(x, dim):
        if isinstance(x, QuantizedTensor):
            return QuantizedTensor(take(x.q, dim.q), take(x.scale, dim.scale))
        if dim is None or ntp == 1:
            return x.clone()
        return x.chunk(ntp, dim=dim)[t].clone()
    return tree_map(take, params, quantize_specs(params,
                                                 G.param_specs(cfg)))


def gather_params(params, cfg: G.GPTConfig, mesh: Optional[ProcessMesh]):
    """The full tree from this rank's slices, the inverse of
    :func:`shard_params` (JAX's global view of a sharded array): every
    leaf ``param_specs`` splits is all-gathered over the tp group along
    its dimension, a replicated one copied.  Collective over tp; a tree
    of the same nesting, such as an Adam moment's, gathers alike.  What a
    change of tp degree goes through: gather, checkpoint, and
    :func:`shard_params` onto the new mesh."""
    ntp = mesh.size(TP_AXIS) if mesh is not None else 1

    def full(x, dim):
        x = x.detach()
        if dim is None or ntp == 1:
            return x.clone()
        return C.all_gather(x, mesh.group(TP_AXIS), axis=dim, tiled=True)
    return tree_map(full, params, G.param_specs(cfg))


def init_gpt(cfg: G.GPTConfig, mesh: Optional[ProcessMesh], seed: int = 0,
             device=None):
    """This rank's f32 parameter shards, from the full tree drawn from
    ``torch.Generator(device).manual_seed(seed)`` (the same on every
    rank).  Build the optimizer on ``tree_leaves`` of the result."""
    device = resolve_device(device)
    full = G.init_params(torch.Generator(device=device).manual_seed(seed),
                         cfg)
    return shard_params(full, cfg, mesh)


def _local_batch(tokens, mesh: Optional[ProcessMesh]):
    """This rank's block of a global [B, T] array: rows by dp, columns by
    sp (JAX's ``P(dp, sp)``)."""
    if mesh is None:
        return tokens
    dp, sp = mesh.size(DP_AXIS), mesh.size(SP_AXIS)
    B, T = tokens.shape
    if B % dp or T % sp:
        raise ValueError(f"batch {B} x sequence {T} does not split over "
                         f"dp {dp} x sp {sp}")
    b, s = B // dp, T // sp
    d, j = mesh.index(DP_AXIS), mesh.index(SP_AXIS)
    return tokens[d * b:(d + 1) * b, j * s:(j + 1) * s]


def _sync_gradients(masters, mesh: Optional[ProcessMesh]) -> None:
    """Sum every gradient over the (dp, sp) group, in one all-reduce per
    dtype (the psums of shard_map's AD; see the module's docstring)."""
    if mesh is None or mesh.size(DP_AXIS, SP_AXIS) == 1:
        return
    grads = ops.fused_all_reduce([m.grad for m in masters],
                                 mesh.group(DP_AXIS, SP_AXIS), "SUM")
    for m, g in zip(masters, grads):
        m.grad = g


def make_gpt_train_step(cfg: G.GPTConfig, optimizer: torch.optim.Optimizer,
                        mesh: Optional[ProcessMesh], params,
                        attn: str = "auto", remat=False,
                        compute_dtype=None) -> Callable:
    """``step(tokens, targets) -> loss`` over a (dp, sp, tp) mesh.

    ``params``: this rank's shards (:func:`init_gpt` or
    :func:`shard_params`), the f32 masters that ``optimizer`` was built
    on; the step updates them in place.  ``tokens``/``targets``: the
    GLOBAL [B, T] int batch, the same on every rank (each takes its block:
    rows by dp, columns by sp).  The loss is the global token-mean NLL, the same
    on every rank; this rank's share of it is ``nll.sum() / (B_local *
    T_local * dp * sp)``.  ``mesh=None`` is one process with no group.

    ``attn``: "ring" | "ring_flash" | "ulysses" | "dense" | "flash" |
    "auto" (ring_flash on the card, ring on the CPU); the last three but
    auto attend within the rank's block and need sp == 1.
    ``compute_dtype`` (e.g. ``torch.bfloat16``): mixed precision as in
    ``training.build_train_step``; every float leaf is cast for the step
    and the gradients reach the f32 masters rounded once."""
    ntp = mesh.size(TP_AXIS) if mesh is not None else 1
    nsp = mesh.size(SP_AXIS) if mesh is not None else 1
    G.validate_tp(cfg, ntp)
    if nsp > 1 and attn not in G.SP_ATTN_MODES + ("auto",):
        raise ValueError(f"attn={attn!r} attends within one sequence "
                         f"block; sp={nsp} needs ring, ring_flash or "
                         f"ulysses")
    tp_group = mesh.group(TP_AXIS) if ntp > 1 else None
    sp_group = mesh.group(SP_AXIS) if mesh is not None else None
    replicas = mesh.size(DP_AXIS, SP_AXIS) if mesh is not None else 1

    def local_loss(p, batch):
        tokens, targets = batch
        logits = G.forward_local(p, tokens, cfg, attn=attn, remat=remat,
                                 tp_group=tp_group, sp_group=sp_group)
        nll = G.parallel_cross_entropy(logits, targets, tp_group)
        return nll.sum() / (tokens.numel() * replicas)

    masters, grads_of = _accum_grads_fn(local_loss, params, 1,
                                        compute_dtype, has_aux=False)

    def step(tokens, targets):
        loss, _ = grads_of((_local_batch(tokens, mesh),
                            _local_batch(targets, mesh)))
        _sync_gradients(masters, mesh)
        _update(optimizer, masters)
        if replicas > 1:
            loss = C.all_reduce(loss, mesh.group(DP_AXIS, SP_AXIS), "SUM")
        return loss

    return step


def make_tp_generate(cfg: G.GPTConfig, mesh: ProcessMesh, n_tokens: int,
                     temperature: float = 0.0,
                     max_len: Optional[int] = None) -> Callable:
    """Tensor-parallel generation: ``fn(params, prompt, generator=None)
    -> [B, n_tokens]`` int32, where ``params`` are this rank's shards
    (:func:`shard_params`, or the masters :func:`make_gpt_train_step`
    trained) and ``prompt`` [B, T] is the same on every rank.  Collective:
    every rank of the mesh's tp group calls it and gets the same tokens.

    The rank's KV cache holds its KV-head shard, each layer's partial
    products are summed over tp, and every step all-gathers the
    vocabulary-sharded logits (:func:`models.gpt.tp_head`), so each rank
    picks the same token; sampled (``temperature`` > 0) from a
    ``generator`` seeded alike on every rank."""
    ntp = mesh.size(TP_AXIS)
    G.validate_tp(cfg, ntp)
    group = mesh.group(TP_AXIS)
    L = max_len or cfg.max_seq

    def fn(params, prompt, generator=None):
        cache = G.init_kv_cache(cfg, prompt.shape[0], L,
                                device=prompt.device, tp=ntp)
        return G.generate(params, cfg, prompt, n_tokens,
                          temperature=temperature, generator=generator,
                          cache=cache, tp_group=group,
                          head=lambda x: G.tp_head(params, x, group))

    return fn
