"""The PCS checkpoint tier (port of ``repro.persistence``)."""
from repro_torch.persistence.store import DurableStore, HostBufferTier
from repro_torch.persistence.manager import (PCSCheckpointManager,
                                             PersistScheme, ShardState)

__all__ = ["DurableStore", "HostBufferTier", "PCSCheckpointManager",
           "PersistScheme", "ShardState"]
