// The in-order window fold of the cell-file machines for Hopper (sm_90a).
// It replaces the XLA lowering of the reference's lax.scan in
// ra_tpu/core/machine.py::JitMachine.sequential_window_fold (:252-279) for
// the machines whose state is one int32 cell file a replica:
// RegisterMachine (ra_tpu/models/registers.py:44-80), JitKvMachine
// (ra_tpu/models/jit_kv.py:56-91) and TtlKvMachine
// (ra_tpu/models/ttl_kv.py:81-124), which add a value, an expiry and a
// watcher file plus a logical clock.  One template, one op decoder a
// machine.  The plain torch version is the machine's
// sequential_window_fold (ra_tpu_torch/core/machine.py); the two are equal
// on every state leaf.  Replies are not computed: the engine discards them
// on this path, as the reference does.
//
// One thread a replica row (lane n, member p) walks its window in order:
// for each masked command it decodes [op, key, value, x] and applies it to
// the row's cells in device memory.  The commands are the lane's [N,A,4]
// window read through the strides of the engine's expanded [N,P,A,4] view
// (member stride 0), so the P replicas of a lane share one copy in L1/L2;
// the mask and index likewise come with their strides.
//
// It folds every window, the ones the reference's vectorised fast fold
// would take included (the two folds agree there).  The output rows are
// first copied from the input rows by the whole block (coalesced: a
// block's rows are one contiguous run of each leaf), then each thread
// folds its own row.
//
// Bound: memory.  Each state leaf is read once and written once, plus the
// commands, mask and index once: at 10,000 x 5 replicas of 64 cells that is
// 2 x 12.8 MB + 20.8 MB of commands (shared by the 5 members) + 6.5 MB of
// mask + 5.2 MB of index.  The decoders are a few integer ops a command.
// Integer adds wrap modulo 2^32, as XLA's int32 arithmetic.  The kernel
// allocates nothing, never synchronises, and runs on the caller's stream,
// so a CUDA graph can capture it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 128;
enum Kind { kRegisters = 0, kKv = 1, kTtlKv = 2 };

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace

struct RaSlotFoldArgs {
  const int* cells;      // [rows, S] values (registers, KV cells, TTL vals)
  int* out_cells;
  const int* exp;        // TTL-KV only: [rows, S] expiry, else null
  int* out_exp;
  const int* watch;      // TTL-KV only: [rows, S] watcher counts
  int* out_watch;
  const int* clock;      // TTL-KV only: [rows] logical clock
  int* out_clock;
  const int* cmds;       // [N,P,A,4] by strides
  const bool* mask;      // [N,P,A] by strides
  const int* index;      // [N,P,A] by strides (raft index of each command)
  long long cmd_stride[4];
  long long mask_stride[3];
  long long index_stride[3];
  int n, p, a, s;
};

// copy rows [row0, row0 + nrows) of a [rows, width] leaf, all threads
__device__ __forceinline__ void copy_rows(const int* src, int* dst,
                                          long long row0, int nrows,
                                          int width) {
  const long long base = row0 * width;
  const long long count = (long long)nrows * width;
  for (long long i = threadIdx.x; i < count; i += blockDim.x)
    dst[base + i] = src[base + i];
}

template <int KIND>
__global__ void __launch_bounds__(kRowsPerBlock)
slot_fold_kernel(const RaSlotFoldArgs a) {
  const long long rows = (long long)a.n * a.p;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  const int nrows = (int)min((long long)kRowsPerBlock, rows - row0);
  const int S = a.s;
  copy_rows(a.cells, a.out_cells, row0, nrows, S);
  if (KIND == kTtlKv) {
    copy_rows(a.exp, a.out_exp, row0, nrows, S);
    copy_rows(a.watch, a.out_watch, row0, nrows, S);
  }
  __syncthreads();
  if ((int)threadIdx.x >= nrows) return;

  const long long row = row0 + threadIdx.x;
  const int n = (int)(row / a.p), p = (int)(row % a.p);
  int* cells = a.out_cells + row * S;
  int* exp = KIND == kTtlKv ? a.out_exp + row * S : nullptr;
  int* watch = KIND == kTtlKv ? a.out_watch + row * S : nullptr;
  int clock = KIND == kTtlKv ? a.clock[row] : 0;
  const int* cmd0 = a.cmds + n * a.cmd_stride[0] + p * a.cmd_stride[1];
  const bool* mask0 = a.mask + n * a.mask_stride[0] + p * a.mask_stride[1];
  const int* index0 =
      a.index + n * a.index_stride[0] + p * a.index_stride[1];
  const long long cs = a.cmd_stride[3];

  for (int i = 0; i < a.a; ++i) {
    if (!mask0[i * a.mask_stride[2]]) continue;
    const int* c = cmd0 + i * a.cmd_stride[2];
    const int op = c[0], key = c[cs], value = c[2 * cs], x = c[3 * cs];
    const bool key_ok = key >= 0 && key < S;
    const int k = clip(key, 0, S - 1);
    if (KIND == kRegisters) {
      // x = expected; a slot outside the file is clipped into it
      const int cur = cells[k];
      if (op == 1) cells[k] = value;
      else if (op == 2) cells[k] = wrap_add(cur, value);
      else if (op == 3 && cur == x) cells[k] = value;
    } else if (KIND == kKv) {
      // x = expected; bad keys and values leave the cells alone
      if (!key_ok) continue;
      if (op == 1 && value >= 0) cells[k] = value;
      else if (op == 3) cells[k] = -1;
      else if (op == 4 && value >= -1 && cells[k] == x) cells[k] = value;
    } else {
      // x = ttl; every applied command advances the clock to its index
      const int idx = index0[i * a.index_stride[2]];
      clock = idx > clock ? idx : clock;
      if (!key_ok) continue;
      if (op == 1 && value >= 0) {
        cells[k] = value;
        exp[k] = x > 0 ? wrap_add(clock, x) : 0;
      } else if (op == 3) {
        cells[k] = -1;
      } else if (op == 4) {
        watch[k] = wrap_add(watch[k], 1);
      }
    }
  }
  if (KIND == kTtlKv) a.out_clock[row] = clock;
}

template <int KIND>
static int launch(const RaSlotFoldArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.n * a.p;
  const unsigned blocks =
      (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  slot_fold_kernel<KIND><<<blocks, kRowsPerBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ra_slot_fold_args_size() {
  return (int)sizeof(RaSlotFoldArgs);
}

extern "C" int ra_slot_fold(const RaSlotFoldArgs* a, int kind,
                            void* stream) {
  if ((long long)a->n * a->p <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kRegisters: return launch<kRegisters>(*a, s);
    case kKv: return launch<kKv>(*a, s);
    case kTtlKv: return launch<kTtlKv>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
