"""Elastic cluster membership: the config server, the resize protocol,
failure recovery, the sharded trainer and the policies (counterpart of
kungfu_tpu/elastic)."""
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
from .sharded import ShardedElasticTrainer, ShardedStateError
from .trainer import ElasticTrainer

__all__ = [
    "snapshot", "state", "ConfigServer", "fetch_config", "put_config",
    "fetch_health", "HeartbeatSender", "AsyncCommitter",
    "ElasticTrainer", "DistributedElasticTrainer", "ShardedElasticTrainer",
    "ShardedStateError", "BasePolicy",
    "PolicyContext", "PolicyRunner", "ScheduledResizePolicy",
    "GNSScalingPolicy", "Stage", "StepSchedule", "ElasticDataShard",
]
