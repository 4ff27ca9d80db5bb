// The in-order window fold of the cell-file machines for Hopper (sm_90a).
// It replaces the XLA lowering of the reference's lax.scan in
// ra_tpu/core/machine.py::JitMachine.sequential_window_fold (:252-279) for
// the machines whose state is one int32 cell file a replica:
// RegisterMachine (ra_tpu/models/registers.py:44-80), JitKvMachine
// (ra_tpu/models/jit_kv.py:56-91) and TtlKvMachine
// (ra_tpu/models/ttl_kv.py:81-124), which add a value, an expiry and a
// watcher file plus a logical clock, and StreamMachine
// (ra_tpu/models/stream.py:77-116: a ring of Q values, G consumer cursors,
// a tail and a base), whose windows holding a cursor commit or a truncate
// the reference folds in order (stream.py:120-125).  One template, one op
// decoder a machine.  The plain torch version is the machine's
// sequential_window_fold (ra_tpu_torch/core/machine.py); the two are equal
// on every state leaf.  Replies are not computed: the engine discards them
// on this path, as the reference does.
//
// Bound: memory.  Each state leaf is read once and written once, plus the
// commands, mask and index once: at 10,000 x 5 replicas of 64 cells that is
// 2 x 12.8 MB of KV cells + 20.8 MB of commands (shared by the 5 members)
// + 6.5 MB of mask, 52.9 MB in all, 0.016 ms at 3.35 TB/s; TTL-KV's three
// files, clock and index make it 109.7 MB, 0.033 ms; the stream's ring of
// 64 and 4 cursors (2 x 14.0 MB of state with tail and base), its 3-wide
// commands (15.6 MB) and the mask make it 50.1 MB, 0.015 ms.
//
// Design: one thread a replica row (lane n, member p) walks its window in
// order; a command is a few integer ops on one cell, so lanes of a warp
// sharing a row would mostly idle.
//  * The row's cell files live in shared memory while it folds, read from
//    device memory once (cp.async, every copy in flight at once) and
//    written once, with no copy pass from input to output.  They are
//    cell-major, cell k of the block's row t at k * (R + 1) + t for R rows
//    a block: a warp loads and stores 32 consecutive cells of one row
//    (coalesced, 128 bytes) into 32 banks, and in the fold the members of
//    a lane, which touch the same key, hit neighbouring banks.  TTL-KV's
//    clock stays in a register, and so do the stream's tail and base; its
//    cursors are a second file of G cells after the ring's Q.
//  * The block's rows of the mask are staged in shared memory too (one
//    contiguous run of bytes, copied 16 bytes at a time): read by each
//    thread from device memory, a warp's mask bytes would touch 32 lines
//    a load.
//  * The commands are the lane's [N,A,C] window read through the strides
//    of the engine's expanded [N,P,A,C] view (member stride 0), so the P
//    members of a lane share one copy in L1; a row loads the next 8
//    commands (one 16-byte load each where the layout allows, and TTL-KV's
//    index) while it folds the 8 before.  The stream's commands are
//    3-wide (C = 3), read a field at a time.
//  * Waves: R is the one of 128, 96, 64, 32 that keeps the most rows on an
//    SM, cells and mask counted.  KV at 64 cells and A = 130 takes R = 96
//    (37 KB a block, 6 blocks, 576 rows an SM): 10,000 x 5 rows fit in one
//    wave.  TTL-KV's three files take R = 32 (30 KB, 7 blocks, 224 rows an
//    SM): two waves, the second 0.7 of the first.
//  * Files or windows too wide for even one row in shared memory take a
//    slower route with the same results: the block copies its rows to
//    their output rows, and each thread folds its row there in device
//    memory, reading its mask bytes through their strides.
// Integer adds wrap modulo 2^32, as XLA's int32 arithmetic, and the ring
// slot of an offset is its floor mod Q (jnp.mod), negative offsets too.
// The kernel allocates nothing, never synchronises the device, and runs on
// the caller's stream, so a CUDA graph can capture it.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 128;        // rows a block, at most
constexpr int kBatch = 8;            // commands loaded a batch ahead
constexpr int kSmemPerSm = 233472;   // sm_90: 228 KB of shared memory an SM
constexpr int kSmemPerBlock = 232448;  // 227 KB a block, by opt-in
constexpr int kSmemReserved = 1024;    // the runtime's share of a block
constexpr int kMaxDevices = 64;       // devices a process opts in on
enum Kind { kRegisters = 0, kKv = 1, kTtlKv = 2, kStream = 3 };

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// jnp.mod(x, q) for q > 0: the remainder takes the sign of q
__device__ __forceinline__ int floor_mod(int x, int q) {
  const int r = x % q;
  return r < 0 ? r + q : r;
}

}  // namespace

struct RaSlotFoldArgs {
  const int* cells;      // [rows, S] values (registers, KV cells, TTL vals,
  int* out_cells;        //   the stream's ring)
  const int* exp;        // TTL-KV only: [rows, S] expiry, else null
  int* out_exp;
  const int* watch;      // TTL-KV only: [rows, S] watcher counts
  int* out_watch;
  const int* clock;      // TTL-KV only: [rows] logical clock
  int* out_clock;
  const int* cursors;    // stream only: [rows, G] consumer cursors
  int* out_cursors;
  const int* tail;       // stream only: [rows] next offset
  int* out_tail;
  const int* base;       // stream only: [rows] oldest retained offset
  int* out_base;
  const int* cmds;       // [N,P,A,C] by strides
  const bool* mask;      // [N,P,A] by strides
  const int* index;      // TTL-KV only: [N,P,A] by strides (raft index of
                         //   each command), else null
  long long cmd_stride[4];
  long long mask_stride[3];
  long long index_stride[3];
  int n, p, a, s;
  int g;                 // stream only: cursors a row, else 0
  int c;                 // command width: 4, or 3 for the stream
};

namespace {

// int32 cells a row holds in the block's files: S, three files of S for
// TTL-KV, the ring and the cursors for the stream
__host__ __device__ inline int row_cells(int kind, const RaSlotFoldArgs& a) {
  return kind == kTtlKv ? 3 * a.s : kind == kStream ? a.s + a.g : a.s;
}

// rows [row0, row0 + nrows) of a [rows, S] file into the block's
// cell-major copy (stride R + 1): warp w takes rows w, w + warps, ...,
// lane l cells l, l + 32, ...; every copy is in flight at once (cp.async)
__device__ __forceinline__ void load_rows(int* smem, const int* src,
                                          long long row0, int nrows, int S,
                                          int stride) {
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < nrows; r += warps) {
    const int* g = src + (row0 + r) * S;
    for (int k = lane; k < S; k += 32)
      __pipeline_memcpy_async(smem + k * stride + r, g + k, sizeof(int));
  }
}

// the same rows from device memory to device memory, [nrows, S] as one run
__device__ __forceinline__ void copy_rows(int* dst, const int* src,
                                          long long row0, int nrows, int S) {
  const long long len = (long long)nrows * S;
  for (long long e = threadIdx.x; e < len; e += blockDim.x)
    dst[row0 * S + e] = src[row0 * S + e];
}

__device__ __forceinline__ void store_rows(const int* smem, int* dst,
                                           long long row0, int nrows, int S,
                                           int stride) {
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < nrows; r += warps) {
    int* g = dst + (row0 + r) * S;
#pragma unroll 4
    for (int k = lane; k < S; k += 32) g[k] = smem[k * stride + r];
  }
}

// the block's rows of the mask, row-major [nrows, A] bytes, into shared
// memory at ``base`` (16-byte aligned, 16 bytes of slack after); returns where
// row 0 starts.  The engine's mask is contiguous: one run of bytes, copied
// 16 bytes at a time with its alignment kept.  Other strides go byte by
// byte.
__device__ __forceinline__ const unsigned char* load_mask(
    unsigned char* base, const RaSlotFoldArgs& a, long long row0,
    int nrows) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long len = (long long)nrows * a.a;
  const unsigned char* gm = reinterpret_cast<const unsigned char*>(a.mask);
  if (a.mask_stride[2] == 1 && a.mask_stride[1] == a.a &&
      a.mask_stride[0] == (long long)a.p * a.a) {
    const unsigned char* g0 = gm + row0 * a.a;
    unsigned char* s0 = base + ((uintptr_t)g0 & 15);
    const long long head = min((long long)((16 - ((uintptr_t)g0 & 15)) & 15),
                               len);
    const long long chunks = (len - head) / 16;
    for (long long e = tid; e < head; e += nt) s0[e] = g0[e];
    for (long long j = tid; j < chunks; j += nt)
      __pipeline_memcpy_async(s0 + head + 16 * j, g0 + head + 16 * j, 16);
    for (long long e = head + 16 * chunks + tid; e < len; e += nt)
      s0[e] = g0[e];
    return s0;
  }
  for (long long e = tid; e < len; e += nt) {
    const long long r = e / a.a, i = e - r * a.a, row = row0 + r;
    base[e] = gm[row / a.p * a.mask_stride[0] + row % a.p * a.mask_stride[1] +
                 i * a.mask_stride[2]];
  }
  return base;
}

// shared bytes a block of ``rows`` takes: the cell files, then the mask
// (with room to align it and to keep its run's alignment)
size_t smem_bytes(int kind, const RaSlotFoldArgs& a, int rows) {
  return sizeof(int) * (size_t)row_cells(kind, a) * (rows + 1) +
         (size_t)rows * a.a + 32;
}

// SMEM: the block's rows of the files and the mask in shared memory;
// else the rows fold in their output rows in device memory
template <int KIND, bool SMEM>
__global__ void __launch_bounds__(kMaxRows)
slot_fold_kernel(const RaSlotFoldArgs a, const int rows_per_block,
                 const int vec_cmds) {
  extern __shared__ int4 smem4[];
  int* const smem = reinterpret_cast<int*>(smem4);
  const int R = rows_per_block, S = a.s;
  const long long rows = (long long)a.n * a.p;
  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)min((long long)R, rows - row0);
  // cell k of the block's row t at k * kst + t * tst
  const int kst = SMEM ? R + 1 : 1, tst = SMEM ? 1 : S;
  int* const cells = SMEM ? smem : a.out_cells + row0 * S;
  int* const exp = KIND != kTtlKv ? nullptr
                  : SMEM ? smem + S * kst : a.out_exp + row0 * S;
  int* const watch = KIND != kTtlKv ? nullptr
                    : SMEM ? smem + 2 * S * kst : a.out_watch + row0 * S;
  // the stream's cursors: cell g of row t at g * kst + t * gst
  const int G = a.g, gst = SMEM ? 1 : G;
  int* const curs = KIND != kStream ? nullptr
                   : SMEM ? smem + S * kst : a.out_cursors + row0 * G;
  const unsigned char* smask = nullptr;
  if (SMEM) {
    load_rows(cells, a.cells, row0, nrows, S, kst);
    if (KIND == kTtlKv) {
      load_rows(exp, a.exp, row0, nrows, S, kst);
      load_rows(watch, a.watch, row0, nrows, S, kst);
    }
    if (KIND == kStream) load_rows(curs, a.cursors, row0, nrows, G, kst);
    const uintptr_t after = (uintptr_t)(smem + row_cells(KIND, a) * kst);
    smask = load_mask(
        reinterpret_cast<unsigned char*>((after + 15) & ~(uintptr_t)15), a,
        row0, nrows);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    copy_rows(a.out_cells, a.cells, row0, nrows, S);
    if (KIND == kTtlKv) {
      copy_rows(a.out_exp, a.exp, row0, nrows, S);
      copy_rows(a.out_watch, a.watch, row0, nrows, S);
    }
    if (KIND == kStream) copy_rows(a.out_cursors, a.cursors, row0, nrows, G);
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < nrows) {
    const long long row = row0 + t;
    const long long n = row / a.p, p = row % a.p;
    int clock = KIND == kTtlKv ? a.clock[row] : 0;
    int tail = KIND == kStream ? a.tail[row] : 0;
    int base = KIND == kStream ? a.base[row] : 0;
    const int* cmd0 = a.cmds + n * a.cmd_stride[0] + p * a.cmd_stride[1];
    const int* index0 = KIND != kTtlKv ? nullptr
        : a.index + n * a.index_stride[0] + p * a.index_stride[1];
    const unsigned char* m = SMEM ? smask + (long long)t * a.a : nullptr;
    const bool* gmask =
        a.mask + n * a.mask_stride[0] + p * a.mask_stride[1];
    const long long cs = a.cmd_stride[3];
    // the next batch's commands (and indexes) load while this one folds
    int4 next[kBatch];
    int next_idx[kBatch];
    auto fetch = [&](int i0) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b < a.a ? i0 + b : a.a - 1;
        const int* ci = cmd0 + i * a.cmd_stride[2];
        if (vec_cmds) next[b] = __ldg(reinterpret_cast<const int4*>(ci));
        else next[b] = make_int4(ci[0], ci[cs], ci[2 * cs],
                                 a.c > 3 ? ci[3 * cs] : 0);
        if (KIND == kTtlKv) next_idx[b] = index0[i * a.index_stride[2]];
      }
    };
    if (a.a > 0) fetch(0);
    for (int i0 = 0; i0 < a.a; i0 += kBatch) {
      int4 c[kBatch];
      int idx[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        c[b] = next[b];
        idx[b] = next_idx[b];
      }
      if (i0 + kBatch < a.a) fetch(i0 + kBatch);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (i0 + b >= a.a) continue;
        if (SMEM ? !m[i0 + b] : !gmask[(i0 + b) * a.mask_stride[2]])
          continue;
        if (KIND == kStream) {
          // x = offset or group, y = cursor offset; the unsigned sums wrap
          // as XLA's int32 adds
          const int op = c[b].x, x = c[b].y, y = c[b].z;
          const bool app = op == 1 && x >= 0;
          if (app) cells[(long long)floor_mod(tail, S) * kst + t * tst] = x;
          const int new_tail = app ? wrap_add(tail, 1) : tail;
          if (op == 2 && x >= 0 && x < G) {
            int* const cur = curs + x * kst + t * gst;
            // max-merge, then clip to [0, new_tail]: min(max(., 0), tail)
            const int merged = *cur > y ? *cur : y;
            const int lo = merged > 0 ? merged : 0;
            *cur = lo < new_tail ? lo : new_tail;
          } else if (op == 3) {
            const int merged = base > x ? base : x;
            const int lo = merged > 0 ? merged : 0;
            base = lo < new_tail ? lo : new_tail;
          }
          // retention, after every applied command: the ring keeps Q
          const int floor_base = wrap_add(new_tail, -S);
          base = base > floor_base ? base : floor_base;
          tail = new_tail;
          continue;
        }
        const int op = c[b].x, key = c[b].y, value = c[b].z, x = c[b].w;
        const bool key_ok = key >= 0 && key < S;
        const int k = clip(key, 0, S - 1);
        const long long off =
            SMEM ? (long long)(k * kst + t) : (long long)t * tst + k;
        int* const cell = cells + off;
        if (KIND == kRegisters) {
          // x = expected; a slot outside the file is clipped into it
          const int cur = *cell;
          if (op == 1) *cell = value;
          else if (op == 2) *cell = wrap_add(cur, value);
          else if (op == 3 && cur == x) *cell = value;
        } else if (KIND == kKv) {
          // x = expected; bad keys and values leave the cells alone
          if (!key_ok) continue;
          if (op == 1 && value >= 0) *cell = value;
          else if (op == 3) *cell = -1;
          else if (op == 4 && value >= -1 && *cell == x) *cell = value;
        } else {
          // x = ttl; every applied command advances the clock to its index
          clock = idx[b] > clock ? idx[b] : clock;
          if (!key_ok) continue;
          if (op == 1 && value >= 0) {
            *cell = value;
            exp[off] = x > 0 ? wrap_add(clock, x) : 0;
          } else if (op == 3) {
            *cell = -1;
          } else if (op == 4) {
            watch[off] = wrap_add(watch[off], 1);
          }
        }
      }
    }
    if (KIND == kTtlKv) a.out_clock[row] = clock;
    if (KIND == kStream) {
      a.out_tail[row] = tail;
      a.out_base[row] = base;
    }
  }
  if (SMEM) {
    __syncthreads();
    store_rows(cells, a.out_cells, row0, nrows, S, kst);
    if (KIND == kTtlKv) {
      store_rows(exp, a.out_exp, row0, nrows, S, kst);
      store_rows(watch, a.out_watch, row0, nrows, S, kst);
    }
    if (KIND == kStream) store_rows(curs, a.out_cursors, row0, nrows, G, kst);
  }
}

template <int KIND>
int launch(const RaSlotFoldArgs& a, cudaStream_t stream) {
  // rows a block: of 128, 96, 64, 32 (then fewer, for wide files) the one
  // that keeps the most rows on an SM, the larger on a tie; none fits:
  // 128 rows folding in device memory
  int best = 0, rows_per_block = 0;
  for (int r = kMaxRows; r >= 1; r = r > 32 ? r - 32 : r / 2) {
    const size_t bytes = smem_bytes(KIND, a, r);
    if (bytes > (size_t)kSmemPerBlock) continue;
    const int threads = (r + 31) / 32 * 32;
    int blocks = (int)(kSmemPerSm / (bytes + kSmemReserved));
    blocks = blocks < 2048 / threads ? blocks : 2048 / threads;
    blocks = blocks < 32 ? blocks : 32;
    if (blocks * r > best) {
      best = blocks * r;
      rows_per_block = r;
    }
    if (r <= 32 && best > 0) break;
  }
  const bool in_smem = rows_per_block > 0;
  if (!in_smem) rows_per_block = kMaxRows;
  const size_t smem =
      in_smem ? smem_bytes(KIND, a, rows_per_block) : 0;
  // the opt-in is an attribute of the kernel on each device: keep it
  // per device, or a launch on a second card goes above 48 KB
  // without it
  static size_t opted[kMaxDevices];
  int dev = 0;
  const cudaError_t ge = cudaGetDevice(&dev);
  if (ge != cudaSuccess) return (int)ge;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        slot_fold_kernel<KIND, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = smem;
  }
  const int vec_cmds =
      a.c >= 4 && a.cmd_stride[3] == 1 && a.cmd_stride[2] % 4 == 0 &&
      a.cmd_stride[1] % 4 == 0 && a.cmd_stride[0] % 4 == 0 &&
      ((uintptr_t)a.cmds & 15) == 0;
  const long long rows = (long long)a.n * a.p;
  const unsigned blocks =
      (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  const int threads = (rows_per_block + 31) / 32 * 32;
  if (in_smem)
    slot_fold_kernel<KIND, true><<<blocks, threads, smem, stream>>>(
        a, rows_per_block, vec_cmds);
  else
    slot_fold_kernel<KIND, false><<<blocks, threads, 0, stream>>>(
        a, rows_per_block, vec_cmds);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ra_slot_fold_args_size() {
  return (int)sizeof(RaSlotFoldArgs);
}

extern "C" int ra_slot_fold(const RaSlotFoldArgs* a, int kind,
                            void* stream) {
  if ((long long)a->n * a->p <= 0) return (int)cudaSuccess;
  if (a->s < 1 || (kind == kStream && a->g < 1) ||
      a->c < (kind == kStream ? 3 : 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kRegisters: return launch<kRegisters>(*a, s);
    case kKv: return launch<kKv>(*a, s);
    case kTtlKv: return launch<kTtlKv>(*a, s);
    case kStream: return launch<kStream>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
