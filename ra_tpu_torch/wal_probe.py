"""The write rate of the durable engine's WAL plane on one filesystem.

    python -m ra_tpu_torch.wal_probe [DIR] [--shards 4]

Writes ``TOTAL_MB`` megabytes of records of ``RECORD_BYTES`` each through
``--shards`` of the port's :class:`ra_tpu_torch.log.wal.Wal` (one file,
writer thread and fdatasync each, group commit as the durable engine runs
it), each shard keeping at most ``WINDOW`` unconfirmed records in flight,
and prints one JSON line: the filesystem type of ``DIR`` (from
``/proc/mounts``) and its free bytes, whether the native I/O library or
the Python fallback ran, the confirmed MB/s, fsyncs, records per fsync
and fsync p50/p99.  A record is one full-width durable step of the bench
shape (10,000 lanes x 128 int32 rows and three int32[N] headers).
``DIR`` (default ``build/wal_probe`` under the checkout) is removed
afterwards.  This measures the disk and the WAL plane alone: no
engine, no device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import threading
import time
from pathlib import Path

from .log.faults import IO
from .log.wal import Wal

DEFAULT_DIR = Path(__file__).resolve().parents[1] / "build" / "wal_probe"
#: megabytes written in all, the bytes of a record, and the unconfirmed
#: records a shard keeps in flight (the bench's ``max_pending``)
TOTAL_MB = 1024.0
RECORD_BYTES = 10_000 * 128 * 4 + 3 * 10_000 * 4
WINDOW = 32


def fs_info(path: str) -> dict:
    """The filesystem type and mount point holding ``path`` (the longest
    mount point in ``/proc/mounts`` that prefixes it) and its free
    bytes."""
    real = os.path.realpath(path)
    best = ("", "unknown")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt = parts[1].replace("\\040", " ")
                if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) >= len(best[0]):
                    best = (mnt, parts[2])
    except OSError:
        pass
    return {"path": real, "mount": best[0], "fs_type": best[1],
            "free_bytes": shutil.disk_usage(real).free}


def probe(data_dir: str, shards: int) -> dict:
    os.makedirs(data_dir, exist_ok=True)
    info = fs_info(data_dir)
    rec = os.urandom(RECORD_BYTES)
    n_per = max(1, int(TOTAL_MB * 2**20 / RECORD_BYTES) // shards)
    cond = threading.Condition()
    confirmed = [0] * shards
    wals = []
    for i in range(shards):
        wal = Wal(os.path.join(data_dir, f"shard{i:02d}"), sync_mode=1)

        def notify(uid, lo, hi, term, i=i):
            with cond:
                confirmed[i] = max(confirmed[i], hi)
                cond.notify_all()
        wal.register("probe", notify)
        wals.append(wal)

    def writer(i: int) -> None:
        for idx in range(1, n_per + 1):
            with cond:
                cond.wait_for(lambda: idx - confirmed[i] <= WINDOW)
            # distinct images: the WAL interns equal payloads per file
            wals[i].write("probe", idx, 1,
                          (i * n_per + idx).to_bytes(8, "little") + rec[8:])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with cond:
        cond.wait_for(lambda: min(confirmed) >= n_per, timeout=600)
    seconds = time.perf_counter() - t0
    stats = [w.stats() for w in wals]
    for w in wals:
        w.close()
    shutil.rmtree(data_dir, ignore_errors=True)
    syncs = sum(s["syncs"] for s in stats)
    written = sum(s["bytes_written"] for s in stats)
    return {"probe": "wal", **info, "native_io": IO._base.native,
            "shards": shards, "window": WINDOW, "record_bytes": len(rec),
            "records": n_per * shards, "seconds": seconds,
            "mb_per_s": written / seconds / 1e6, "fsyncs": syncs,
            "records_per_fsync": n_per * shards / syncs if syncs else -1.0,
            "fsync_p50_ms": statistics.median(s["fsync_p50_ms"]
                                              for s in stats),
            "fsync_p99_ms": max(s["fsync_p99_ms"] for s in stats)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir", nargs="?", default=str(DEFAULT_DIR))
    ap.add_argument("--shards", type=int, default=4)
    a = ap.parse_args(argv)
    print(json.dumps(probe(a.dir, a.shards)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
