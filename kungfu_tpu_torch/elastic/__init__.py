"""Elastic cluster membership: the config server, the resize protocol and
the policies (counterpart of kungfu_tpu/elastic; the sharded trainer and
the background committer are not ported yet)."""
from . import snapshot, state
from .config_server import ConfigServer, fetch_config, put_config
from .dataset import ElasticDataShard
from .multiproc import DistributedElasticTrainer
from .policy import (BasePolicy, GNSScalingPolicy, PolicyContext,
                     PolicyRunner, ScheduledResizePolicy)
from .schedule import Stage, StepSchedule
from .trainer import ElasticTrainer

__all__ = [
    "snapshot", "state", "ConfigServer", "fetch_config", "put_config",
    "ElasticTrainer", "DistributedElasticTrainer", "BasePolicy",
    "PolicyContext", "PolicyRunner", "ScheduledResizePolicy",
    "GNSScalingPolicy", "Stage", "StepSchedule", "ElasticDataShard",
]
