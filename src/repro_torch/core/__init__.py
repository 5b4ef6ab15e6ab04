"""CRUM core — the paper's contribution, over PyTorch state on a CUDA card."""
from repro_torch.core.shadow import (
    HostShardView,
    ShadowStateManager,
    ChunkState,
    SyncStats,
)
from repro_torch.core.forked import (
    CheckpointResult,
    ForkedCheckpointer,
    ForkPersistBackend,
    PersistBackend,
    PersistJob,
    ThreadPersistBackend,
    list_persist_backends,
    register_persist_backend,
)
from repro_torch.core.restore import LazyLeaves, RestoreManager
from repro_torch.core.drain import drain
from repro_torch.core.policy import CheckpointPolicy, referenced_steps
from repro_torch.core.failure import (
    HeartbeatMonitor,
    RestartBudget,
    StragglerPolicy,
    PreemptionHandler,
)
from repro_torch.core.trainer import CheckpointedTrainer

__all__ = [
    "HostShardView", "ShadowStateManager", "ChunkState", "SyncStats",
    "ForkedCheckpointer", "CheckpointResult",
    "PersistBackend", "PersistJob",
    "ThreadPersistBackend", "ForkPersistBackend",
    "list_persist_backends", "register_persist_backend",
    "LazyLeaves", "RestoreManager", "drain",
    "CheckpointPolicy", "referenced_steps",
    "HeartbeatMonitor", "RestartBudget", "StragglerPolicy",
    "PreemptionHandler",
    "CheckpointedTrainer",
]
