"""MoE-GPT: the GPT family with switch-MoE FFN layers, trained dp x ep
(counterpart of kungfu_tpu/parallel/moe_gpt.py).

Every ``expert_every``-th transformer block swaps its dense MLP for the
switch-MoE FFN of :mod:`.moe` through the model's ``ffn`` hook
(``models.gpt.apply_layer``): top-1 routing with static capacity,
experts sharded over the ``ep`` group, tokens exchanged with two
all-to-alls.  Outside the expert blocks both dp and ep act as data axes
(the batch's rows split over dp x ep jointly, dp major), so the
non-expert gradients are summed over (dp, ep) and the expert gradients
over dp only, where JAX's AD inserts the psums.

Each rank's loss is ``nll.sum() / total + aux_weight * aux / (dp *
ep)``, where ``aux`` is the layers' mean aux loss averaged over ep and
dp (``comm.collectives.pmean``, whose gradient is the identity): the
ranks' losses sum to the global one, and each rank's gradients are its
share of the global gradient, as JAX's varying-axis AD gives them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..comm import collectives as C
from ..comm.mesh import ProcessMesh, shard_tree
from ..models import gpt as G
from ..training import _accum_grads_fn, _update
from ..utils.device import resolve_device
from . import moe as M

DP_AXIS, EP_AXIS = M.DP_AXIS, M.EP_AXIS
mesh_dp_ep = M.mesh_dp_ep


@dataclasses.dataclass(frozen=True)
class MoEGPTConfig:
    gpt: G.GPTConfig
    n_experts: int = 8
    expert_every: int = 2          # every k-th layer is MoE (the last of k)
    capacity_factor: float = 1.25
    aux_weight: float = 0.01

    def is_moe_layer(self, i: int) -> bool:
        return i % self.expert_every == self.expert_every - 1

    @property
    def moe(self) -> M.MoEConfig:
        return M.MoEConfig(d_model=self.gpt.d_model, d_ff=self.gpt.d_ff,
                           n_experts=self.n_experts,
                           capacity_factor=self.capacity_factor,
                           dtype=self.gpt.dtype)


def param_shapes(cfg: MoEGPTConfig) -> dict:
    """The tree's shapes: the dense GPT's, with each MoE layer's ``wi``
    and ``wm`` replaced by ``moe: {router [D, E], wi [E, D, F],
    wo [E, F, D]}``."""
    out = G.param_shapes(cfg.gpt)
    D, Fd, E = cfg.gpt.d_model, cfg.gpt.d_ff, cfg.n_experts
    for i, layer in enumerate(out["layers"]):
        if cfg.is_moe_layer(i):
            del layer["wi"], layer["wm"]
            layer["moe"] = {"router": (D, E), "wi": (E, D, Fd),
                            "wo": (E, Fd, D)}
    return out


def init_params(gen: torch.Generator, cfg: MoEGPTConfig) -> dict:
    """Dense GPT parameters with the MoE layers' MLPs replaced by expert
    banks, f32, drawn from ``gen`` on its device."""
    base = G.init_params(gen, cfg.gpt)
    layers = []
    for i, layer in enumerate(base["layers"]):
        if cfg.is_moe_layer(i):
            layer = {k: v for k, v in layer.items()
                     if k not in ("wi", "wm")}
            layer["moe"] = M.init_moe_params(gen, cfg.moe)
        layers.append(layer)
    out = dict(base)
    out["layers"] = layers
    return out


def param_specs(cfg: MoEGPTConfig, ep: Optional[str] = EP_AXIS) -> dict:
    """``comm.mesh.shard_tree``'s specs: everything replicated but the
    experts, split over ``ep``."""
    out = {k: () for k in G.param_shapes(cfg.gpt) if k != "layers"}
    out["layers"] = []
    for layer in param_shapes(cfg)["layers"]:
        spec = {k: () for k in layer if k != "moe"}
        if "moe" in layer:
            spec["moe"] = M.moe_param_specs(ep)
        out["layers"].append(spec)
    return out


def shard_params(params, cfg: MoEGPTConfig, mesh: Optional[ProcessMesh]):
    """This rank's shards of a full tree (its experts; the rest whole)."""
    return shard_tree(params, param_specs(cfg), mesh)


def init_moe_gpt(cfg: MoEGPTConfig, mesh: Optional[ProcessMesh],
                 seed: int = 0, device=None):
    """This rank's f32 shards of the tree drawn from
    ``torch.Generator(device).manual_seed(seed)`` (the same on every
    rank).  Build the optimizer on ``tree_leaves`` of the result."""
    device = resolve_device(device)
    return shard_params(init_params(
        torch.Generator(device=device).manual_seed(seed), cfg), cfg, mesh)


def forward_local(params, tokens, cfg: MoEGPTConfig, ep_group=None):
    """This rank's forward -> (f32 logits [B, T, V], the layers' mean aux
    loss, averaged over ``ep_group``).  Without ``ep_group`` every expert
    is local (the oracle).  The layers attend through the flash kernels
    K1-K4 on a CUDA batch, densely on a CPU one
    (``models.gpt.auto_attn``)."""
    g = cfg.gpt
    attn = G.auto_attn(tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = G.embed(params, tokens, pos[None], g)
    aux_acc = []

    def moe_ffn_cb(layer, h):
        y, aux = M.moe_ffn(layer["moe"], h, cfg.moe, ep_group=ep_group,
                           residual=False)
        aux_acc.append(aux)
        return y

    for layer in params["layers"]:
        ffn = moe_ffn_cb if "moe" in layer else None
        x = G.apply_layer(layer, x, g, attn=attn, ffn=ffn, pos=pos)
    x = G.rms_norm(x, params["lnf"])
    logits = torch.einsum("btd,dv->btv", x.float(),
                          params["lm_head"].float())
    aux = (sum(aux_acc) / len(aux_acc) if aux_acc
           else torch.zeros((), device=tokens.device))
    return logits, aux


def _expert_leaves(params) -> list:
    """For each leaf in ``tree_leaves`` order: whether it is an expert
    bank (``layers/i/moe/wi`` or ``wo``)."""
    def walk(node, path):
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in walk(node[k],
                                                           path + (k,))]
        if isinstance(node, (list, tuple)):
            return [x for i, t in enumerate(node)
                    for x in walk(t, path + (i,))]
        return [len(path) > 2 and path[-2] == "moe"
                and path[-1] in ("wi", "wo")]
    return walk(params, ())


def make_train_step(cfg: MoEGPTConfig, optimizer: torch.optim.Optimizer,
                    mesh: Optional[ProcessMesh], params,
                    compute_dtype=None) -> Callable:
    """``step(tokens, targets) -> loss`` over a (dp, ep) mesh.

    ``params``: this rank's shards (:func:`init_moe_gpt` or
    :func:`shard_params`), the f32 masters ``optimizer`` was built on;
    the step updates them in place.  ``tokens``/``targets``: the GLOBAL
    [B, T] int batch, the same on every rank (each takes its rows, split
    over dp x ep).  The loss is the global token-mean NLL plus
    ``aux_weight`` x the mean aux loss, the same on every rank.
    ``mesh=None``: one process with every expert local.
    ``compute_dtype``: mixed precision as in ``threed``."""
    if mesh is not None and cfg.n_experts % mesh.size(EP_AXIS) != 0:
        raise ValueError(f"{cfg.n_experts} experts not divisible by "
                         f"{mesh.size(EP_AXIS)} expert-parallel ranks")
    n = mesh.size(DP_AXIS, EP_AXIS) if mesh is not None else 1
    ep_group = mesh.group(EP_AXIS) if mesh is not None else None
    dp_group = mesh.group(DP_AXIS) if mesh is not None else None

    def local_loss(p, batch):
        tokens, targets = batch
        logits, aux = forward_local(p, tokens, cfg, ep_group=ep_group)
        nll = G.parallel_cross_entropy(logits, targets)
        if dp_group is not None:
            aux = C.pmean(aux, dp_group)
        return nll.sum() / (tokens.numel() * n) + cfg.aux_weight * aux / n

    masters, grads_of = _accum_grads_fn(local_loss, params, 1,
                                        compute_dtype, has_aux=False)
    expert_leaf = _expert_leaves(params)

    def step(tokens, targets):
        loss, _ = grads_of((M._rows(tokens, mesh), M._rows(targets, mesh)))
        M._sync_gradients(masters, expert_leaf, mesh)
        _update(optimizer, masters)
        if n > 1:
            loss = C.all_reduce(loss, mesh.group(DP_AXIS, EP_AXIS), "SUM")
        return loss

    return step
