"""Collective communication over ``torch.distributed`` (counterpart of
kungfu_tpu/comm): mesh axes as process groups, the XLA-native
collectives, and the differentiable ones of the parallel envelope."""
from .collectives import (all_gather, all_reduce, all_to_all,  # noqa: F401
                          broadcast, copy_to_group, gather_from_group,
                          hierarchical_all_reduce,
                          pmax, ppermute, reduce_from_group, reduce_scatter,
                          reduce_to_root, ring_exchange)
from .mesh import (PEER_AXIS, ProcessMesh, flat_mesh,  # noqa: F401
                   init_process_group_file, make_mesh, serving_mesh)
