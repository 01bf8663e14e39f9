"""Elastic cluster membership: the config server, the resize protocol,
failure recovery and the policies (counterpart of kungfu_tpu/elastic; the
sharded trainer is not ported yet)."""
from . import snapshot, state
from .config_server import (ConfigServer, fetch_config, fetch_health,
                            put_config)
from .dataset import ElasticDataShard
from .heartbeat import HeartbeatSender
from .multiproc import DistributedElasticTrainer
from .snapshot import AsyncCommitter
from .policy import (BasePolicy, GNSScalingPolicy, PolicyContext,
                     PolicyRunner, ScheduledResizePolicy)
from .schedule import Stage, StepSchedule
from .trainer import ElasticTrainer

__all__ = [
    "snapshot", "state", "ConfigServer", "fetch_config", "put_config",
    "fetch_health", "HeartbeatSender", "AsyncCommitter",
    "ElasticTrainer", "DistributedElasticTrainer", "BasePolicy",
    "PolicyContext", "PolicyRunner", "ScheduledResizePolicy",
    "GNSScalingPolicy", "Stage", "StepSchedule", "ElasticDataShard",
]
