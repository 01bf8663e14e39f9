"""Collective communication over ``torch.distributed`` (counterpart of
kungfu_tpu/comm): the peer axis as a process group and the XLA-native
collectives."""
from .collectives import (all_gather, all_reduce, broadcast,  # noqa: F401
                          hierarchical_all_reduce, reduce_scatter,
                          reduce_to_root, ring_exchange)
from .mesh import PEER_AXIS, flat_mesh, init_process_group_file  # noqa: F401
