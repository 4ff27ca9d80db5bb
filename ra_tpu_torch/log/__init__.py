"""The log plane of the port (copies of ``ra_tpu/log``): the fan-in WAL
with its write strategies and its storage fault plans, and the classic
plane's ``MemoryLog``, ``DurableLog``, segments and snapshots."""
from .durable import DurableLog
from .memory import MemoryLog
from .segment import SegmentFile, SegmentWriter
from .snapshot import DEFAULT_SNAPSHOT_MODULE, SnapshotModule
from .wal import Wal, WalDown, scan_wal_file

__all__ = ["DEFAULT_SNAPSHOT_MODULE", "DurableLog", "MemoryLog",
           "SegmentFile", "SegmentWriter", "SnapshotModule", "Wal",
           "WalDown", "scan_wal_file"]
