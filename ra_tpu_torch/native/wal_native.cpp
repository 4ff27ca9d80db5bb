// Native hot path for the fan-in write-ahead log.
//
// The reference's WAL hot loop (batch encode + write(2) + fsync,
// ra_log_wal.erl:488-560,753-800) runs on the BEAM's
// native runtime; this library is the equivalent layer for ra_tpu_torch: the
// Python WAL thread hands a fully-encoded batch buffer to wal_write_batch,
// which performs the write + durability syscall with the GIL released
// (ctypes releases it for the call).  Record checksums use zlib.crc32 on
// the Python side — same polynomial, no FFI overhead per record.
//
// Built at first use by ra_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -o build/ra_tpu_torch/libra_wal-<hash>.so wal_native.cpp
//
// Exposed (C ABI):
//   int      ra_wal_open(const char *path, int truncate);
//   int      ra_wal_open_sync(const char *path, int truncate); // O_SYNC
//   int      ra_wal_sync(int fd, int mode);   // 1=fdatasync 2=fsync
//   long     ra_wal_write_batch(int fd, const uint8_t *buf, size_t len,
//                               int sync_mode);  // 0=none 1=fdatasync 2=fsync
//   int      ra_wal_close(int fd);
//   long     ra_pwrite(int fd, const uint8_t *buf, size_t len, long off);
//   long     ra_pread(int fd, uint8_t *buf, size_t len, long off);

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

extern "C" {

int ra_wal_open(const char *path, int truncate) {
  int flags = O_CREAT | O_RDWR | O_APPEND;
  if (truncate) flags |= O_TRUNC;
  return open(path, flags, 0644);
}

// o_sync variant: the file descriptor itself is synchronous, so write(2)
// returns only after the data is durable: the `o_sync` write strategy
// (ra_log_wal.erl:66-96), where no separate fsync happens.
int ra_wal_open_sync(const char *path, int truncate) {
  int flags = O_CREAT | O_RDWR | O_APPEND | O_SYNC;
  if (truncate) flags |= O_TRUNC;
  return open(path, flags, 0644);
}

// standalone durability syscall (the batch is written with sync_mode 0,
// then synced here and timed): 1=fdatasync 2=fsync
int ra_wal_sync(int fd, int mode) {
  int r = 0;
  if (mode == 1) r = fdatasync(fd);
  else if (mode == 2) r = fsync(fd);
  return r == 0 ? 0 : -errno;
}

long ra_wal_write_batch(int fd, const uint8_t *buf, size_t len,
                        int sync_mode) {
  size_t done = 0;
  while (done < len) {
    ssize_t n = write(fd, buf + done, len - done);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -(long)errno;
    }
    done += (size_t)n;
  }
  if (sync_mode == 1) {
    if (fdatasync(fd) != 0) return -(long)errno;
  } else if (sync_mode == 2) {
    if (fsync(fd) != 0) return -(long)errno;
  }
  return (long)done;
}

int ra_wal_close(int fd) { return close(fd); }

long ra_pwrite(int fd, const uint8_t *buf, size_t len, long off) {
  size_t done = 0;
  while (done < len) {
    ssize_t n = pwrite(fd, buf + done, len - done, off + (long)done);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -(long)errno;
    }
    done += (size_t)n;
  }
  return (long)done;
}

long ra_pread(int fd, uint8_t *buf, size_t len, long off) {
  size_t done = 0;
  while (done < len) {
    ssize_t n = pread(fd, buf + done, len - done, off + (long)done);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -(long)errno;
    }
    if (n == 0) break;
    done += (size_t)n;
  }
  return (long)done;
}

}  // extern "C"
