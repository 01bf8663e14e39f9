"""kungfu_tpu_torch — the PyTorch + CUDA port of kungfu_tpu.

A second package beside the JAX one, module for module where a
counterpart exists.  Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas for the TPU becomes a kernel written by hand for
Hopper (``ops/csrc``), built from the checkout at first use.

What is ported so far is the serving path (the GPT model's decode code,
the paged KV cache with its paged-decode CUDA kernel, the
continuous-batching engine, its HTTP front end and CLI,
``python -m kungfu_tpu_torch.serving``), the GPT training path (the GPT
forward with the flash-attention CUDA kernels, chunked cross-entropy,
``torch.distributed`` collectives, synchronous SGD and the train step,
``python -m kungfu_tpu_torch.benchmarks.gpt``), the kernel roofline
(``python -m kungfu_tpu_torch.benchmarks.roofline``), ResNet-50
training (the ResNet family with its BatchNorm state, the train step
with state, the data loaders and the pinned-memory Prefetcher,
``python -m kungfu_tpu_torch.benchmarks.resnet``), with the rest of the
model zoo (the MNIST perceptrons, VGG16/19, BERT), the optimizer family
(SMA, adaptive SGD, pair averaging, the noise-scale and variance
monitors) and the elastic data plane: the config server, the versioned
rendezvous (``distributed``), the elastic trainers with their state
re-sync and version fence, the watcher that spawns and reaps workers,
checkpoints, and the top-level worker API below
(``python -m kungfu_tpu_torch.examples.elastic_resize``).

The package imports neither JAX nor anything of ``kungfu_tpu``; it keeps
its own copy of what it needs.  Entry points run on ``cuda`` unless the
caller asks for the CPU, and raise when no CUDA device is present.

The worker API reads the worker's description that :func:`init`
installs (``--kf-*`` flags; see ``launcher.env``) and the live data
group, where the JAX package reads variables of the environment and its
native peer.
"""
from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

from .utils.device import resolve_device

__version__ = "0.1.0"


def init(argv: Optional[Sequence[str]] = None):
    """Install this worker's description from the ``--kf-*`` flags of
    ``argv`` (default ``sys.argv``) and return it (a singleton one when
    there are none)."""
    from .launcher import env as E
    return E.install(E.parse(sys.argv[1:] if argv is None else argv))


def _env():
    from .launcher import env as E
    return E.installed()


def _live():
    import torch.distributed as dist

    from . import distributed as D
    return D.is_initialized() and dist.is_initialized()


def current_rank() -> int:
    """Rank of this worker: in the live data group, else in the installed
    description, else 0."""
    if _live():
        import torch.distributed as dist
        return dist.get_rank()
    return _env().rank()


def current_cluster_size() -> int:
    """Workers in the cluster: the live data group's, else the installed
    description's, else 1."""
    if _live():
        import torch.distributed as dist
        return dist.get_world_size()
    return _env().size()


def current_local_rank() -> int:
    we = _env()
    return 0 if we.singleton else we.peers.local_rank(we.self_spec)


def current_local_size() -> int:
    we = _env()
    return 1 if we.singleton else we.peers.local_size(we.self_spec)


def run_barrier() -> None:
    """A barrier over the live data group (a no-op for a singleton)."""
    if _live():
        from . import distributed as D
        D.barrier()


def detached() -> bool:
    """True once a resize removed this worker."""
    from .elastic import state
    return state.is_detached()


def uid() -> str:
    """The worker's identity ``host:port:version`` (the version it was
    started at); a singleton's is ``localhost:<pid>:0``."""
    we = _env()
    if we.singleton:
        return f"localhost:{os.getpid()}:0"
    p = we.self_spec
    return f"{p.host}:{p.port}:{we.cluster_version}"


def propose_new_size(new_size: int, url: Optional[str] = None) -> bool:
    """Propose a cluster size to the config server (``url``, default the
    installed description's): fetch the cluster, resize it, and PUT it as
    a compare-and-swap on the fetched version.  True when the PUT won;
    False when the server is unreachable or another proposal won first.
    The workers pick the change up at their next fence."""
    import urllib.error

    from .elastic.config_server import fetch_config, put_config
    url = url or _env().config_server
    if not url:
        raise RuntimeError("propose_new_size: no config server (start the "
                           "worker with --kf-config-server)")
    try:
        version, cluster = fetch_config(url)
        put_config(url, cluster.resize(int(new_size)), if_version=version)
    except (urllib.error.URLError, OSError, TimeoutError):
        return False
    return True


__all__ = ["resolve_device", "init", "current_rank", "current_cluster_size",
           "current_local_rank", "current_local_size", "run_barrier",
           "detached", "uid", "propose_new_size"]
