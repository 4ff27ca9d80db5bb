"""ctypes bindings for the native WAL/IO library, with a Python fallback.

The port's own copy of ``ra_tpu/native``.  The library is built from
``wal_native.cpp`` beside this file with g++, at first use and never at
import, into ``build/ra_tpu_torch/libra_wal-<hash>.so`` under the
checkout root (the hash covers the source and the flags, so a stale
library is never loaded).  Where g++ is missing or fails, the I/O falls
back to os-level Python calls with ``zlib.crc32``: the same semantics,
lower throughput.  The fallback is never silent: it logs a warning with
the compiler's output, and ``IO.native`` says which one runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import zlib
from pathlib import Path

SRC = Path(__file__).resolve().parent / "wal_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ra_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

logger = logging.getLogger("ra_tpu_torch.native")


def target() -> Path:
    """Where the library built from :data:`SRC` lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libra_wal-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    """Compile :data:`SRC` into ``so`` (through a temporary file, so a
    concurrent build never loads a half-written library)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        out = getattr(exc, "stderr", "") or ""
        logger.warning("native WAL library not built (%r%s); using the "
                       "Python I/O fallback", exc,
                       f": {out[-400:]}" if out else "")
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    return True


def _load():
    """The loaded library, or None where it cannot be built."""
    so = target()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as exc:
        logger.warning("native WAL library %s not loaded (%r); using the "
                       "Python I/O fallback", so, exc)
        return None
    lib.ra_wal_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ra_wal_open.restype = ctypes.c_int
    lib.ra_wal_open_sync.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ra_wal_open_sync.restype = ctypes.c_int
    lib.ra_wal_sync.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ra_wal_sync.restype = ctypes.c_int
    lib.ra_wal_write_batch.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_size_t, ctypes.c_int]
    lib.ra_wal_write_batch.restype = ctypes.c_long
    lib.ra_wal_close.argtypes = [ctypes.c_int]
    lib.ra_pwrite.argtypes = [ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_size_t, ctypes.c_long]
    lib.ra_pwrite.restype = ctypes.c_long
    lib.ra_pread.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char),
                             ctypes.c_size_t, ctypes.c_long]
    lib.ra_pread.restype = ctypes.c_long
    return lib


class NativeIO:
    """Thin facade over the native lib (or the Python fallback).

    Records io operation counts/bytes (the ra_file_handle role,
    ra_file_handle.erl:26-40).  Plain int adds — approximate under
    concurrency, like any sampled io metric; reads via :meth:`stats`."""

    def __init__(self) -> None:
        self._lib = None
        self._loaded = False
        self._load_lock = threading.Lock()
        self._stats = {"reads": 0, "read_bytes": 0, "writes": 0,
                       "write_bytes": 0, "syncs": 0, "opens": 0}

    @property
    def lib(self):
        """The native library, built and loaded on first use (None when
        the Python fallback runs)."""
        if not self._loaded:
            with self._load_lock:
                if not self._loaded:
                    self._lib = _load()
                    self._loaded = True
        return self._lib

    @property
    def native(self) -> bool:
        """True when the native library does the I/O."""
        return self.lib is not None

    def stats(self) -> dict:
        return dict(self._stats)

    def random_open(self, path: str, truncate: bool = False) -> int:
        """Open for positioned I/O (pwrite/pread).  MUST NOT use O_APPEND:
        Linux pwrite ignores the offset on O_APPEND fds."""
        flags = os.O_CREAT | os.O_RDWR
        if truncate:
            flags |= os.O_TRUNC
        self._stats["opens"] += 1
        return os.open(path, flags, 0o644)

    # sync_mode: 0=none, 1=fdatasync, 2=fsync
    def wal_open(self, path: str, truncate: bool = False,
                 o_sync: bool = False) -> int:
        """o_sync opens the fd with O_SYNC: every write(2) is durable on
        return (the WAL's ``o_sync`` write strategy)."""
        if self.native:
            fn = self.lib.ra_wal_open_sync if o_sync else \
                self.lib.ra_wal_open
            fd = fn(path.encode(), 1 if truncate else 0)
        else:
            flags = os.O_CREAT | os.O_RDWR | os.O_APPEND
            if o_sync:
                flags |= os.O_SYNC
            if truncate:
                flags |= os.O_TRUNC
            fd = os.open(path, flags, 0o644)
        if fd < 0:
            raise OSError(f"wal_open failed for {path}: {fd}")
        self._stats["opens"] += 1
        return fd

    def sync(self, fd: int, mode: int = 1) -> None:
        """Standalone durability syscall after a batch written with
        sync_mode 0 (the WAL times it on its own; the sync_after_notify
        strategy runs it after the confirms)."""
        if mode == 0:
            return
        self._stats["syncs"] += 1
        if self.native:
            r = self.lib.ra_wal_sync(fd, mode)
            if r < 0:
                raise OSError(f"wal sync failed: errno {-r}")
            return
        if mode == 1:
            try:
                os.fdatasync(fd)
            except AttributeError:
                os.fsync(fd)
        else:
            os.fsync(fd)

    def write_batch(self, fd: int, buf: bytes, sync_mode: int = 1) -> int:
        self._stats["writes"] += 1
        self._stats["write_bytes"] += len(buf)
        if sync_mode:
            self._stats["syncs"] += 1
        if self.native:
            n = self.lib.ra_wal_write_batch(fd, buf, len(buf), sync_mode)
            if n < 0:
                raise OSError(f"wal write failed: errno {-n}")
            return n
        os.write(fd, buf)
        if sync_mode == 1:
            try:
                os.fdatasync(fd)
            except AttributeError:
                os.fsync(fd)
        elif sync_mode == 2:
            os.fsync(fd)
        return len(buf)

    def pwrite(self, fd: int, buf: bytes, off: int) -> int:
        self._stats["writes"] += 1
        self._stats["write_bytes"] += len(buf)
        if self.native:
            n = self.lib.ra_pwrite(fd, buf, len(buf), off)
            if n < 0:
                raise OSError(f"pwrite failed: errno {-n}")
            return n
        return os.pwrite(fd, buf, off)

    def pread(self, fd: int, length: int, off: int) -> bytes:
        self._stats["reads"] += 1
        self._stats["read_bytes"] += length
        if self.native:
            buf = ctypes.create_string_buffer(length)
            n = self.lib.ra_pread(fd, buf, length, off)
            if n < 0:
                raise OSError(f"pread failed: errno {-n}")
            return buf.raw[:n]
        return os.pread(fd, length, off)

    def crc32(self, data: bytes, seed: int = 0) -> int:
        # zlib.crc32 is the same polynomial (verified bit-identical vs
        # the native slice-by-8 across sizes/seeds) and beats it at every
        # size: no ctypes FFI overhead on small records (~2x) and a
        # hardware-accelerated inner loop on large ones (~2.4x at 1MB)
        return zlib.crc32(data, seed)

    def close(self, fd: int) -> None:
        if self.native:
            self.lib.ra_wal_close(fd)
        else:
            os.close(fd)


IO = NativeIO()
