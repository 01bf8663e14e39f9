"""Expert parallelism: switch-style Mixture-of-Experts over an ``ep`` group
(counterpart of kungfu_tpu/parallel/moe.py).

- top-1 (switch) routing in f32 with a static per-expert **capacity**
  computed from the rank's own token count; overflow tokens pass through
  the residual unchanged;
- experts sharded over ``ep`` (each rank owns ``E / ep`` expert MLPs, a
  GELU MLP in ``cfg.dtype``);
- tokens travel to their expert's owner and back with two tiled
  all-to-alls (``comm.collectives.all_to_all``);
- the switch load-balancing auxiliary loss (E * sum_e fraction_e *
  prob_e), averaged over ep (``comm.collectives.pmean``).

Dispatch and combine index by (expert, slot): each token fills at most
one slot of one expert, so an ``index_add`` into the [E, C, D] buffer and
an ``index_select`` out of it give exactly the values of JAX's dense
one-hot einsums over [n, E, C], without that tensor (n * E * C elements:
537M at 8192 tokens, 8 experts and capacity 8.0).  Every shape stays
static: a dropped token adds zeros to its expert's last slot and takes a
combine weight of 0.

Composes with data parallelism: dp and ep both carry tokens outside the
expert block (the batch's rows split over (dp, ep) jointly, dp major);
only the expert weights are ep-sharded.  :func:`make_moe_step` sums the
router's gradient over (dp, ep) and the experts' over dp, where JAX's AD
inserts the psums.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from ..comm import collectives as C
from ..comm.mesh import ProcessMesh, make_mesh, shard_tree
from ..training import _accum_grads_fn, _update

DP_AXIS, EP_AXIS = "dp", "ep"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 256          # per-expert hidden width
    n_experts: int = 8
    capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16  # expert-compute dtype (routing stays f32)


def mesh_dp_ep(dp: int, ep: int,
               timeout_s: Optional[float] = None) -> Optional[ProcessMesh]:
    """The (dp, ep) mesh over the first dp * ep ranks, ep innermost, with
    the dp, ep and (dp, ep) groups.  Collective, as
    ``comm.mesh.make_mesh``."""
    return make_mesh((DP_AXIS, EP_AXIS), (dp, ep),
                     groups=((DP_AXIS,), (EP_AXIS,), (DP_AXIS, EP_AXIS)),
                     timeout_s=timeout_s)


def init_moe_params(gen: torch.Generator, cfg: MoEConfig) -> dict:
    """Router (replicated) and stacked expert MLPs (leading axis =
    expert), f32 normal draws from ``gen`` on its device, scaled by
    1/sqrt(fan_in) as JAX's (other bits)."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32)
    return {"router": normal(D, E) / math.sqrt(D),
            "wi": normal(E, D, Fd) / math.sqrt(D),
            "wo": normal(E, Fd, D) / math.sqrt(Fd)}


def moe_param_specs(ep: Optional[str] = EP_AXIS) -> dict:
    """The mesh axis each dimension splits over
    (``comm.mesh.shard_tree``'s specs): the experts over ``ep``."""
    return {"router": (), "wi": (ep,), "wo": (ep,)}


def shard_moe_params(params: dict, mesh: Optional[ProcessMesh]) -> dict:
    """This rank's experts of a full tree (the router whole)."""
    return shard_tree(params, moe_param_specs(), mesh)


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.capacity_factor / cfg.n_experts))
    return max(c, 1)


def _route(router, xt, cfg: MoEConfig, C_: int):
    """Top-1 routing of tokens ``xt`` [n, D] in f32: (gate [n], slot [n]
    = expert * C + position, keep [n] bool, local aux loss).  Positions
    count each expert's tokens in token order; a token past capacity is
    not kept.  Argmax ties go to the first expert."""
    E = cfg.n_experts
    logits = xt.float() @ router.float()                     # [n, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = probs.max(dim=-1)
    onehot = F.one_hot(expert, E).float()                     # [n, E]
    aux = E * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1).long() - 1
    keep = pos < C_
    slot = expert * C_ + pos.clamp(max=C_ - 1)
    return gate, slot, keep, aux


def moe_ffn(params: dict, x, cfg: MoEConfig, ep_group=None,
            residual: bool = True) -> Tuple[Any, Any]:
    """Apply the MoE FFN to (this rank's) activations ``x`` [B, T, D].

    With ``ep_group``, ``params["wi"]``/``["wo"]`` hold the rank's
    experts ``[E/ep, ...]`` and tokens are exchanged with two
    all-to-alls; without it they hold all ``E`` (the oracle).  Returns
    ``(y, aux)``: ``y`` includes the residual (an overflowed token passes
    through) unless ``residual=False``, which returns the expert
    contribution alone (a pre-norm block adds its own residual); ``aux``
    is averaged over ``ep_group``."""
    B, T, D = x.shape
    E = cfg.n_experts
    n = B * T
    C_ = _capacity(n, cfg)
    xt = x.reshape(n, D)
    gate, slot, keep, aux = _route(params["router"], xt, cfg, C_)
    if ep_group is not None:
        aux = C.pmean(aux, ep_group)

    # dispatch: each kept token into its (expert, slot), in cfg.dtype
    src = xt.to(cfg.dtype) * keep[:, None].to(cfg.dtype)
    buf = torch.zeros((E * C_, D), dtype=cfg.dtype, device=x.device)
    buf = buf.index_add(0, slot, src).reshape(E, C_, D)

    if ep_group is not None:
        ep = torch.distributed.get_world_size(ep_group)
        e_local = params["wi"].shape[0]
        # each expert block to its owner; [src, e_local, C, D] -> per
        # expert batches [e_local, src * C, D]
        buf = C.all_to_all(buf, ep_group, 0, 0)
        buf = (buf.reshape(ep, e_local, C_, D).transpose(0, 1)
               .reshape(e_local, ep * C_, D))

    h = F.gelu(torch.bmm(buf, params["wi"].to(buf.dtype)),
               approximate="tanh")
    out = torch.bmm(h, params["wo"].to(buf.dtype))

    if ep_group is not None:
        out = (out.reshape(e_local, ep, C_, D).transpose(0, 1)
               .reshape(E, C_, D))
        out = C.all_to_all(out, ep_group, 0, 0)

    # combine in f32: a kept token takes gate * its slot's output
    y = (out.reshape(E * C_, D).float().index_select(0, slot)
         * (gate * keep)[:, None])
    y = y.to(x.dtype).reshape(B, T, D)
    if residual:
        y = x + y          # overflow -> pure residual
    return y, aux


def _rows(t, mesh: Optional[ProcessMesh]):
    """This rank's block of a global batch's rows, split over (dp, ep)
    jointly, dp major (JAX's ``P((dp, ep))``)."""
    if mesh is None:
        return t
    n = mesh.size(DP_AXIS, EP_AXIS)
    if t.shape[0] % n:
        raise ValueError(f"global batch {t.shape[0]} not divisible by "
                         f"dp x ep = {n}")
    b = t.shape[0] // n
    i = mesh.index(DP_AXIS) * mesh.size(EP_AXIS) + mesh.index(EP_AXIS)
    return t[i * b:(i + 1) * b]


def _sync_gradients(masters, expert_leaf, mesh: Optional[ProcessMesh]):
    """Sum the experts' gradients over dp and every other gradient over
    (dp, ep), one fused all-reduce each (the psums of JAX's AD)."""
    if mesh is None:
        return
    for want, axes in ((True, (DP_AXIS,)), (False, (DP_AXIS, EP_AXIS))):
        if mesh.size(*axes) == 1:
            continue
        ms = [m for m, e in zip(masters, expert_leaf) if e == want]
        grads = ops.fused_all_reduce([m.grad for m in ms],
                                     mesh.group(*axes), "SUM")
        for m, g in zip(ms, grads):
            m.grad = g


def make_moe_step(cfg: MoEConfig, optimizer: torch.optim.Optimizer,
                  mesh: Optional[ProcessMesh], params: dict,
                  aux_weight: float = 0.01) -> Callable:
    """The toy regression step over a (dp, ep) mesh, the correctness
    harness for the MoE dataflow: ``step(x, y) -> loss`` on the GLOBAL
    [B, T, D] batch (each rank takes its rows, split over dp x ep), the
    mean squared error plus ``aux_weight`` x the mean aux loss, the same
    on every rank.  ``params``: this rank's shards
    (:func:`shard_moe_params`), the f32 masters ``optimizer`` was built
    on; the step updates them in place.  ``mesh=None``: one process,
    every expert local."""
    if mesh is not None and cfg.n_experts % mesh.size(EP_AXIS) != 0:
        raise ValueError(f"{cfg.n_experts} experts not divisible by "
                         f"{mesh.size(EP_AXIS)} expert-parallel ranks")
    n = mesh.size(DP_AXIS, EP_AXIS) if mesh is not None else 1
    ep_group = mesh.group(EP_AXIS) if mesh is not None else None
    dp_group = mesh.group(DP_AXIS) if mesh is not None else None

    def local_loss(p, batch):
        x, y = batch
        out, aux = moe_ffn(p, x, cfg, ep_group=ep_group)
        mse = torch.mean((out.float() - y.float()) ** 2)
        if dp_group is not None:
            aux = C.pmean(aux, dp_group)
        # this rank's share: the n ranks' terms sum to the global loss
        return (mse + aux_weight * aux) / n

    masters, grads_of = _accum_grads_fn(local_loss, params, 1, None,
                                        has_aux=False)
    expert_leaf = [k in ("wi", "wo") for k in sorted(params)]

    def step(x, y):
        loss, _ = grads_of((_rows(x, mesh), _rows(y, mesh)))
        _sync_gradients(masters, expert_leaf, mesh)
        _update(optimizer, masters)
        if mesh is not None and n > 1:
            loss = C.all_reduce(loss, mesh.group(DP_AXIS, EP_AXIS), "SUM")
        return loss

    return step
