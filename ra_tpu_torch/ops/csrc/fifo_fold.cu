// The in-order window fold of the FIFO machine for Hopper (sm_90a).
// It replaces the XLA lowering of the reference's lax.scan in
// ra_tpu/core/machine.py::JitMachine.sequential_window_fold (:252-279) for
// JitFifoMachine (ra_tpu/models/jit_fifo.py:134-330), the requeue merge of
// :217-273 included.  The plain torch version is the machine's
// sequential_window_fold over ra_tpu_torch/models/jit_fifo.py's jit_apply;
// the two are equal on every state leaf.  Replies are not computed: the
// engine discards them on this path, as the reference does.
//
// One thread a replica row (lane n, member p) walks its window in order
// over the full op 0-11 vocabulary: enqueue under both overflow policies
// (reject, drop_head), settled and unsettled dequeue, settle, return,
// purge, attach, cancel/down, consumer checkout and set_credit.  The row's
// 15 state leaves live in device memory: the ready ring buf/dc/mid [Q],
// the checked-out table co_* [K], the consumers con_* [C] and five
// scalars (kept in registers while the row folds).  The reference merges
// a return or a cancel's requeued rows by rank over a [K,Q] comparison;
// here the rows' ranks are counted over the ready window and the window is
// rebuilt in place, in ascending order of position: every ready entry moves
// back by the requeued rows ranked below it, so its source slot is never
// one already written (the ring holds at most Q live messages).
//
// It folds every window, the ones the reference's vectorised fast fold
// would take included (the two folds agree there).  The block first
// copies its rows of every leaf from input to output (coalesced: a
// block's rows are one contiguous run of each leaf), then each thread
// folds its own row.
//
// Bound: memory.  Each state leaf is read once and written once, plus the
// [N,A,3] commands (shared by a lane's members through a stride-0 member
// axis) and the [N,P,A] mask: at 5,000 x 5 replicas, Q = 256, K = 8, C = 4
// that is 2 x 82 MB of state and 11 MB of commands and mask.  A row's work
// is O(A (K + C)) plus O(K Q) for each return or cancel.  Integer adds wrap
// modulo 2^32, as XLA's int32 arithmetic.  The kernel allocates nothing,
// never synchronises, and runs on the caller's stream, so a CUDA graph can
// capture it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kMaxCheckout = 32;   // the largest K the kernel takes

// the state leaves, in the sorted key order of the machine's dict
enum Leaf {
  kBuf, kCoDc, kCoId, kCoMid, kCoOwner, kCoVal, kConCredit, kConPid, kDc,
  kHead, kMid, kNDropped, kNextId, kNextMid, kTail, kLeaves
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int fmod_q(int x, int q) {   // floor mod
  const int m = x % q;
  return m < 0 ? m + q : m;
}

}  // namespace

struct RaFifoFoldArgs {
  const int* in[kLeaves];
  int* out[kLeaves];
  const int* cmds;       // [N,P,A,3] by strides
  const bool* mask;      // [N,P,A] by strides
  long long cmd_stride[4];
  long long mask_stride[3];
  int n, p, a, q, k, c, drop_head;
};

__device__ __forceinline__ int leaf_width(const RaFifoFoldArgs& a, int l) {
  switch (l) {
    case kBuf: case kDc: case kMid: return a.q;
    case kCoDc: case kCoId: case kCoMid: case kCoOwner: case kCoVal:
      return a.k;
    case kConCredit: case kConPid: return a.c;
    default: return 1;
  }
}

__global__ void __launch_bounds__(kRowsPerBlock)
fifo_fold_kernel(const RaFifoFoldArgs a) {
  const long long rows = (long long)a.n * a.p;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  const int nrows = (int)min((long long)kRowsPerBlock, rows - row0);
  for (int l = 0; l < kLeaves; ++l) {
    const int w = leaf_width(a, l);
    const long long base = row0 * w, count = (long long)nrows * w;
    for (long long i = threadIdx.x; i < count; i += blockDim.x)
      a.out[l][base + i] = a.in[l][base + i];
  }
  __syncthreads();
  if ((int)threadIdx.x >= nrows) return;

  const long long row = row0 + threadIdx.x;
  const int n = (int)(row / a.p), p = (int)(row % a.p);
  const int Q = a.q, K = a.k, C = a.c;
  int* buf = a.out[kBuf] + row * Q;
  int* dc = a.out[kDc] + row * Q;
  int* mid = a.out[kMid] + row * Q;
  int* co_id = a.out[kCoId] + row * K;
  int* co_val = a.out[kCoVal] + row * K;
  int* co_dc = a.out[kCoDc] + row * K;
  int* co_mid = a.out[kCoMid] + row * K;
  int* co_owner = a.out[kCoOwner] + row * K;
  int* con_pid = a.out[kConPid] + row * C;
  int* con_credit = a.out[kConCredit] + row * C;
  int head = a.in[kHead][row], tail = a.in[kTail][row];
  int next_id = a.in[kNextId][row], next_mid = a.in[kNextMid][row];
  int n_dropped = a.in[kNDropped][row];
  const int* cmd0 = a.cmds + n * a.cmd_stride[0] + p * a.cmd_stride[1];
  const bool* mask0 = a.mask + n * a.mask_stride[0] + p * a.mask_stride[1];
  const long long cs = a.cmd_stride[3];
  int rank[kMaxCheckout];

  for (int i = 0; i < a.a; ++i) {
    if (!mask0[i * a.mask_stride[2]]) continue;
    const int* cmd = cmd0 + i * a.cmd_stride[2];
    const int op = cmd[0], x = cmd[cs], y = cmd[2 * cs];

    const int size = wsub(tail, head);
    const bool empty = size <= 0;
    int checked = 0, free_slot = 0, match_slot = 0;
    bool have_free = false, found = false;
    for (int k = 0; k < K; ++k) {
      const int id = co_id[k];
      checked += id >= 0;
      if (id < 0 && !have_free) { have_free = true; free_slot = k; }
      if (x >= 0 && id == x && !found) { found = true; match_slot = k; }
    }
    const bool full = wadd(size, checked) >= Q;

    // -- consumer-table resolution (ops 7-11)
    int pid_slot = 0, free_con_slot = 0;
    bool pid_found = false, have_con_free = false;
    for (int c = 0; c < C; ++c) {
      const int pid = con_pid[c];
      if (x >= 0 && pid == x && !pid_found) {
        pid_found = true;
        pid_slot = c;
      }
      if (pid < 0 && !have_con_free) {
        have_con_free = true;
        free_con_slot = c;
      }
    }
    int used = 0;
    for (int k = 0; k < K; ++k)
      used += co_id[k] >= 0 && co_owner[k] == pid_slot;

    // -- enqueue, dequeue, settle, return, purge, cancel
    const bool enq_ok = op == 1 && !full;
    const bool enq_drop = a.drop_head && op == 1 && full && size > 0;
    const bool enq = enq_ok || enq_drop;
    const int head_slot = fmod_q(head, Q);
    const int head_val = buf[head_slot], head_dc = dc[head_slot];
    const int head_mid = mid[head_slot];
    const bool deq_s = op == 2 && !empty;
    const bool deq_u = op == 3 && !empty && have_free;
    const bool deq_c = op == 10 && pid_found && !empty && have_free &&
                       used < con_credit[pid_slot];
    const bool take = deq_u || deq_c;
    const bool settle = op == 4 && found;
    const bool ret = op == 5 && found;
    const bool cancel = (op == 8 || op == 9) && pid_found;

    n_dropped = wadd(n_dropped, enq_drop);
    int h = wadd(wadd(head, deq_s || take), enq_drop);
    if (op == 6) h = tail;                     // purge
    const int new_tail = wadd(tail, enq);
    if (enq) {
      const int t = fmod_q(tail, Q);
      buf[t] = x;
      dc[t] = 0;
      mid[t] = next_mid;
      next_mid = wadd(next_mid, 1);
    }

    // -- the requeue merge: the returned row, or every row the canceled
    // consumer owns, lands at its ticket rank in the ready window
    int n_req = 0;
    if (ret || cancel) {
      for (int k = 0; k < K; ++k) {
        const bool req = cancel ? (co_id[k] >= 0 && co_owner[k] == pid_slot)
                                : k == match_slot;
        rank[k] = req ? 0 : -1;
        n_req += req;
      }
    }
    if (n_req > 0) {
      const int size2 = wsub(new_tail, h);
      const int win = size2 < Q ? size2 : Q;
      const int h0 = fmod_q(h, Q);
      for (int k = 0; k < K; ++k) {
        if (rank[k] < 0) continue;
        int r = 0;
        for (int j = 0; j < win; ++j)
          r += mid[h0 + j < Q ? h0 + j : h0 + j - Q] < co_mid[k];
        for (int k2 = 0; k2 < K; ++k2)
          r += rank[k2] >= 0 && co_mid[k2] < co_mid[k];
        rank[k] = r;     // a rank is >= 0: the membership flag survives
      }
      const int nh = wsub(h, n_req), nh0 = fmod_q(nh, Q);
      const int span = wadd(size2, n_req);
      const int lim = span < Q ? span : Q;
      for (int jd = 0; jd < lim; ++jd) {
        bool land = false;
        int v = 0, d = 0, m = 0, below = 0;
        for (int k = 0; k < K; ++k) {
          if (rank[k] == jd) {
            land = true;
            v = wadd(v, co_val[k]);
            d = wadd(d, wadd(co_dc[k], 1));
            m = wadd(m, co_mid[k]);
          }
          below += rank[k] >= 0 && rank[k] < jd;
        }
        const int dst = nh0 + jd < Q ? nh0 + jd : nh0 + jd - Q;
        if (!land) {
          const int src = fmod_q(wsub(wadd(h, jd), below), Q);
          v = buf[src];
          d = dc[src];
          m = mid[src];
        }
        buf[dst] = v;
        dc[dst] = d;
        mid[dst] = m;
      }
      h = nh;
    }

    // -- checkout-table writes
    if (take) {
      co_val[free_slot] = head_val;
      co_dc[free_slot] = head_dc;
      co_mid[free_slot] = head_mid;
      co_owner[free_slot] = deq_c ? pid_slot : C;
      co_id[free_slot] = next_id;
      next_id = wadd(next_id, 1);
    }
    if (settle || ret) co_id[match_slot] = -1;
    if (cancel) {
      for (int k = 0; k < K; ++k)
        if (rank[k] >= 0) co_id[k] = -1;
    }

    // -- consumer attach / credit / cancel
    if (op == 7 && (pid_found || have_con_free)) {
      const int s = pid_found ? pid_slot : free_con_slot;
      con_pid[s] = x;
      con_credit[s] = y;
    }
    if (op == 11 && pid_found) con_credit[pid_slot] = y;
    if (cancel) con_pid[pid_slot] = -1;

    head = h;
    tail = new_tail;
  }
  a.out[kHead][row] = head;
  a.out[kTail][row] = tail;
  a.out[kNextId][row] = next_id;
  a.out[kNextMid][row] = next_mid;
  a.out[kNDropped][row] = n_dropped;
}

extern "C" int ra_fifo_fold_args_size() {
  return (int)sizeof(RaFifoFoldArgs);
}

extern "C" int ra_fifo_fold(const RaFifoFoldArgs* a, void* stream) {
  const long long rows = (long long)a->n * a->p;
  if (rows <= 0) return (int)cudaSuccess;
  if (a->k < 1 || a->k > kMaxCheckout || a->q < 1 || a->c < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  fifo_fold_kernel<<<blocks, kRowsPerBlock, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
