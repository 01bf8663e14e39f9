"""Parallelism beyond data parallelism (counterpart of
kungfu_tpu/parallel/__init__.py).

- :mod:`ring_attention`: sequence parallelism, ring attention (dense
  blocks or the flash kernels) and Ulysses all-to-all.
- :mod:`tensor`: Megatron-style column and row parallel products.
- :mod:`threed`: dp x sp x tp training of the GPT family (imported as
  ``kungfu_tpu_torch.parallel.threed``, as it depends on the model).

Every function takes the process group of its axis (a
``comm.mesh.ProcessMesh``'s) where the JAX one takes a mesh axis name.
FSDP, pipeline and expert parallelism come with later slices.
"""
from .ring_attention import (make_ring_attention,  # noqa: F401
                             make_ring_flash_attention,
                             make_ulysses_attention, reference_attention,
                             ring_attention, ring_flash_attention,
                             ulysses_attention)
from .tensor import column_parallel, row_parallel  # noqa: F401

SEQ_AXIS = "sp"

__all__ = [
    "SEQ_AXIS", "ring_attention", "ring_flash_attention",
    "ulysses_attention", "make_ring_attention", "make_ulysses_attention",
    "make_ring_flash_attention", "reference_attention", "column_parallel",
    "row_parallel",
]
