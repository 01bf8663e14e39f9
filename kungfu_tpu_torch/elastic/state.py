"""Process-local elastic flags (counterpart of kungfu_tpu/elastic/state.py).

A peer whose rank disappeared from the cluster after a resize sees
``detached`` and stops training; the cluster version counts the
membership changes this process went through.
"""
_detached = False
_cluster_version = 0


def is_detached() -> bool:
    return _detached


def set_detached(v: bool = True) -> None:
    global _detached
    _detached = v


def cluster_version() -> int:
    return _cluster_version


def set_cluster_version(v: int) -> None:
    """Adopt the version of the membership this process joined."""
    global _cluster_version
    _cluster_version = int(v)


def bump_cluster_version() -> int:
    global _cluster_version
    _cluster_version += 1
    return _cluster_version
