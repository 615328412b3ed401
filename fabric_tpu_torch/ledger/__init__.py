from .blkstorage import BlockStore, BlockStoreError
from .statedb import VersionedValue, StateDB, UpdateBatch
from .historydb import HistoryDB
from .kvledger import KVLedger, LedgerConfig
from .confighistory import ConfigHistory

__all__ = ["BlockStore", "BlockStoreError", "VersionedValue", "StateDB",
           "UpdateBatch", "HistoryDB", "KVLedger", "LedgerConfig",
           "ConfigHistory"]
