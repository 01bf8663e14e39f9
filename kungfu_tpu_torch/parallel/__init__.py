"""Parallelism beyond data parallelism (counterpart of
kungfu_tpu/parallel/__init__.py).

- :mod:`ring_attention`: sequence parallelism, ring attention (dense
  blocks or the flash kernels) and Ulysses all-to-all.
- :mod:`tensor`: Megatron-style column and row parallel products.
- :mod:`fsdp`: ZeRO-3 (flat and a layer at a time) and ZeRO-1 over one
  flat vector, sharded by reduce-scatter and all-gather.
  ``shard_pytree_spec`` has no counterpart: a rank's chunk is a plain
  tensor, not an array placed by a ``NamedSharding``.
- :mod:`threed`: dp x sp x tp training of the GPT family (imported as
  ``kungfu_tpu_torch.parallel.threed``, as it depends on the model).
- :mod:`pipeline`: dp x pp (x tp) training of the GPT family, GPipe and
  the interleaved schedule written out tick by tick (imported as
  ``kungfu_tpu_torch.parallel.pipeline``).
- :mod:`moe`: switch-MoE over an ep group (top-1 routing with capacity,
  two all-to-alls, the load-balancing loss) and its toy dp x ep step.
- :mod:`moe_gpt`: the GPT family with switch-MoE layers, trained dp x ep
  (imported as ``kungfu_tpu_torch.parallel.moe_gpt``).

Every function takes the process group of its axis (a
``comm.mesh.ProcessMesh``'s) where the JAX one takes a mesh axis name.
"""
from .ring_attention import (make_ring_attention,  # noqa: F401
                             make_ring_flash_attention,
                             make_ulysses_attention, reference_attention,
                             ring_attention, ring_flash_attention,
                             ulysses_attention)
from .fsdp import (fsdp_all_gather_params, fsdp_grad_sync,  # noqa: F401
                   make_fsdp_scan_step, make_fsdp_step, make_zero1_step)
from .tensor import column_parallel, row_parallel  # noqa: F401
from .moe import (MoEConfig, init_moe_params, make_moe_step,  # noqa: F401
                  moe_ffn, moe_param_specs)

SEQ_AXIS = "sp"

__all__ = [
    "SEQ_AXIS", "ring_attention", "ring_flash_attention",
    "ulysses_attention", "make_ring_attention", "make_ulysses_attention",
    "make_ring_flash_attention", "reference_attention",
    "fsdp_all_gather_params", "fsdp_grad_sync", "make_fsdp_step",
    "make_fsdp_scan_step", "make_zero1_step", "column_parallel",
    "row_parallel", "MoEConfig", "init_moe_params", "moe_ffn",
    "moe_param_specs", "make_moe_step",
]
