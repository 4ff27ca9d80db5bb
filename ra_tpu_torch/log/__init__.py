"""The WAL plane of the port's durable engine (copies of ``ra_tpu/log``'s
``wal.py`` and ``faults.py``).  The reference's ``DurableLog``, segments
and snapshots belong to the classic host planes and are not ported."""
from .wal import Wal, WalDown, scan_wal_file

__all__ = ["Wal", "WalDown", "scan_wal_file"]
