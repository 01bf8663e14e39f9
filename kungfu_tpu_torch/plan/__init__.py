"""Cluster vocabulary: peers, hosts and the elastic cluster (a private copy
of the parts of kungfu_tpu/plan that the elastic data plane calls)."""
from .cluster import Cluster  # noqa: F401
from .hostspec import (DEFAULT_RUNNER_PORT, DEFAULT_WORKER_PORT,  # noqa: F401
                       HostList, HostSpec)
from .peer import PeerID, PeerList  # noqa: F401
