"""Elastic cluster subsystem: durable notification log, virtual-clock
membership, sticky AZ-aware assignment, eager/cooperative rebalancing
with exactly-once handoff, and lag-driven autoscaling — the paper's
"Kafka Streams consistency and rebalance protocol preserved" claim made
executable on the async engine's virtual clock."""

from repro_torch.cluster.assignor import (AssignorStats, PartitionMeta,
                                    StickyAzAssignor)
from repro_torch.cluster.autoscaler import (Autoscaler, AutoscalePolicy,
                                      ScaleDecision)
from repro_torch.cluster.manager import ClusterStats, ElasticCluster
from repro_torch.cluster.membership import (CRASHED, LEFT, UP, Membership,
                                      WorkerInfo)
from repro_torch.cluster.notification_log import (LogStats, NotificationLog,
                                            OffsetStore)
from repro_torch.cluster.rebalance import RebalanceCoordinator, RebalanceEvent

__all__ = [
    "AssignorStats", "PartitionMeta", "StickyAzAssignor",
    "Autoscaler", "AutoscalePolicy", "ScaleDecision",
    "ClusterStats", "ElasticCluster",
    "CRASHED", "LEFT", "UP", "Membership", "WorkerInfo",
    "LogStats", "NotificationLog", "OffsetStore",
    "RebalanceCoordinator", "RebalanceEvent",
]
