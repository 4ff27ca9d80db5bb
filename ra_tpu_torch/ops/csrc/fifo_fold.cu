// The in-order window fold of the FIFO machine for Hopper (sm_90a).
// It replaces the XLA lowering of the reference's lax.scan in
// ra_tpu/core/machine.py::JitMachine.sequential_window_fold (:252-279) for
// JitFifoMachine (ra_tpu/models/jit_fifo.py:134-330), the requeue merge of
// :217-273 included.  The plain torch version is the machine's
// sequential_window_fold over ra_tpu_torch/models/jit_fifo.py's jit_apply;
// the two are equal on every state leaf.  Replies are not computed: the
// engine discards them on this path, as the reference does.
//
// Bound: memory.  Each state leaf is read once and written once, plus the
// lane's [A,3] commands (shared by its members through the engine's
// stride-0 member axis) and the [N,P,A] mask: at 5,000 x 5 replicas,
// Q = 256, K = 8, C = 4, A = 130 that is 175.25 MB, 0.052 ms at 3.35 TB/s.
//
// Design: a group of G lanes of a warp folds one replica row (lane n,
// member p), G = 8, 16 or 32, the smallest that is >= K and >= C (K = 8,
// C = 4: G = 8, four rows a warp); K <= 32.
//  * The row's state is read from device memory once and written once.
//    Its ready ring buf/dc/mid [Q] lives in shared memory for the whole
//    window (3 KB a row at Q = 256; the stride padded so that the groups of
//    a warp, whose heads usually agree, hit different banks), loaded with
//    16-byte cp.async copies all in flight at once and stored with 16-byte
//    stores where the layout allows.  Lane k < K holds checked-out row k in
//    registers (co_*), lane c < C consumer c (con_*); the five scalars are
//    the same in every lane of the group.  There is no copy pass from
//    input to output and no second pass over the output.  Shared memory
//    and registers set the occupancy: blocks of one warp (four rows,
//    12.7 KB), 16-17 an SM, so 25,000 rows take about three waves.
//  * Wider tables than these take slower routes, with the same results: a
//    ring longer than kMaxSharedRing (no block holds three such rings) is
//    copied to its output ring and folded there in device memory, which
//    needs Q a power of two (the merge's route at the int32 edge, below,
//    needs a scratch copy of the ring, and with Q a power of two that edge
//    never arises); more than 32 consumers stay in the row's output table
//    in device memory, scanned 32 slots a vote.
//  * The commands come G at a time: lane l loads command i0 + l and its
//    mask byte while the group folds the batch before (the lane's members,
//    in neighbouring groups, read the same lines), and each masked command
//    reaches the group by a shuffle.
//  * Table scans are warp votes (__ballot_sync over the group, __popc,
//    __ffs), taken only by the ops that need them: the matching message
//    id, the consumer's slot and the rows it owns.  The live checkout rows
//    and the free consumer slots are kept as bit masks, so an enqueue, a
//    dequeue or a checkout's free slot scans nothing.
//  * The requeue merge of a return or a cancel runs in parallel: each
//    requeued row's rank is the group's sum of its lanes' counts over the
//    ready window, plus a vote over the other requeued rows; the window is
//    then rebuilt in place G slots at a time in ascending order (each slot
//    gathers its source, the group synchronises, then writes), which is
//    safe because a slot's source never lies below it.  Only the slots up
//    to the highest landing rank move: above it the gather is the
//    identity.  Equal ranks (duplicate tickets) land the wrapping sum of
//    their rows, as the reference's one-hot contraction does; their
//    sources can reach past the ring's end, onto the first n_req slots,
//    which are read into registers before the rebuild writes them.  Where
//    the in-place order cannot hold (Q not a power of two with the head at
//    an int32 edge, where the reference's wrapped offsets are not a
//    rotation of the ring) the merge follows the reference slot by slot,
//    gathering from a copy of the ring in the row's output buffer.
//  * A row with nothing to requeue is never merged.  The reference runs
//    its merge behind one lax.cond for the whole batch, which is the same
//    but where Q is not a power of two and a bystander row's head sits at
//    the int32 edge (there its wrapped offsets move that row's entries):
//    the kernel, like the port's plain version, folds each row as the
//    reference folds it alone.
// Integer adds wrap modulo 2^32, as XLA's int32 arithmetic; mod is floor
// mod.  The kernel allocates nothing, never synchronises the device, and
// runs on the caller's stream, so a CUDA graph can capture it.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxCheckout = 32;    // the largest K the kernel takes
constexpr int kSmemPerBlock = 232448;  // sm_90: 227 KB a block, by opt-in
constexpr int kMaxDevices = 64;       // devices a process opts in on
// the longest ring kept in shared memory: one row's three rings, padded
// (choose_layout), fit a block at every G
constexpr int kMaxSharedRing = 19328;

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

struct Ring {
  int q;
  bool pow2;
  __device__ __forceinline__ int mod(int x) const {   // floor mod
    if (pow2) return x & (q - 1);
    const int m = x % q;
    return m < 0 ? m + q : m;
  }
  // (base + off) mod q for 0 <= base < q, 0 <= off < q
  __device__ __forceinline__ int at(int base, int off) const {
    const int s = base + off;
    return s >= q ? s - q : s;
  }
};

// the G lanes of a warp that fold one row
template <int G>
struct Group {
  static constexpr unsigned kLow = G == 32 ? 0xffffffffu : (1u << G) - 1;
  unsigned mask;   // the group's lanes in the warp
  int base;        // its first lane in the warp
  int lane;        // 0 .. G-1
  __device__ __forceinline__ unsigned vote(bool p) const {
    return (__ballot_sync(mask, p) >> base) & kLow;
  }
  __device__ __forceinline__ int bcast(int v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  __device__ __forceinline__ int sum(int v) const {
    return __reduce_add_sync(mask, v);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// one row's state while it folds
struct Row {
  int *buf, *dc, *mid;          // the ready ring, in shared memory
  int *sbuf, *sdc, *smid;       // its output rings: the merge's scratch
  int head, tail, next_id, next_mid, n_dropped;
  int co_id, co_val, co_dc, co_mid, co_owner;   // lane k < K: row k
};

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

namespace {

// what the host chooses for a launch
struct Layout {
  int rows_per_block;   // rows folded by one block (a group each)
  int shared;           // 1: the rings in shared memory, 0: in device memory
  int row_ints;         // shared ints a row: buf, dc, mid at stride qs
  int qs;               // the ring's stride in shared memory
  int vec;              // 1: the rings move with 16-byte accesses
};

// The consumer table for C <= G: lane c holds consumer c in registers, and
// the free slots (con_pid < 0) are kept as a bit mask.  Slots are the
// group's lanes; -1 is no slot.
template <int G>
struct RegConsumers {
  int pid, credit;
  unsigned free;
  __device__ __forceinline__ void load(const Group<G>& g,
                                       const RaFifoFoldArgs& a,
                                       long long row) {
    const bool is_c = g.lane < a.c;
    const long long co = row * a.c + g.lane;
    pid = is_c ? a.in[kConPid][co] : -1;
    credit = is_c ? a.in[kConCredit][co] : 0;
    free = g.vote(is_c && pid < 0);
  }
  __device__ __forceinline__ void store(const Group<G>& g,
                                        const RaFifoFoldArgs& a,
                                        long long row) const {
    if (g.lane < a.c) {
      a.out[kConPid][row * a.c + g.lane] = pid;
      a.out[kConCredit][row * a.c + g.lane] = credit;
    }
  }
  // the slot attached as x (lanes past C hold -1, never an x >= 0)
  __device__ __forceinline__ int find(const Group<G>& g, int x) const {
    const unsigned m = x >= 0 ? g.vote(pid == x) : 0u;
    return m ? __ffs(m) - 1 : -1;
  }
  __device__ __forceinline__ int first_free(const Group<G>&) const {
    return free ? __ffs(free) - 1 : -1;
  }
  __device__ __forceinline__ int credit_of(const Group<G>& g, int s) const {
    return g.bcast(credit, s);
  }
  __device__ __forceinline__ void put(const Group<G>& g, int s, int x,
                                      int y) {
    if (g.lane == s) {
      pid = x;
      credit = y;
    }
    free = x >= 0 ? free & ~(1u << s) : free | 1u << s;
  }
  __device__ __forceinline__ void set_credit(const Group<G>& g, int s,
                                             int y) {
    if (g.lane == s) credit = y;
  }
  __device__ __forceinline__ void detach(const Group<G>& g, int s) {
    if (g.lane == s) pid = -1;
    free |= 1u << s;
  }
};

// The consumer table for C > G: the row's output table in device memory,
// copied from the input once and scanned G slots a vote.  Lane 0 writes;
// the group synchronises after each write, so every lane reads it.
template <int G>
struct MemConsumers {
  int* pid;
  int* credit;
  int c;
  __device__ __forceinline__ void load(const Group<G>& g,
                                       const RaFifoFoldArgs& a,
                                       long long row) {
    c = a.c;
    pid = a.out[kConPid] + row * c;
    credit = a.out[kConCredit] + row * c;
    for (int s = g.lane; s < c; s += G) {
      pid[s] = a.in[kConPid][row * c + s];
      credit[s] = a.in[kConCredit][row * c + s];
    }
    g.sync();
  }
  __device__ __forceinline__ void store(const Group<G>&,
                                        const RaFifoFoldArgs&,
                                        long long) const {}
  __device__ __forceinline__ int find(const Group<G>& g, int x) const {
    if (x < 0) return -1;
    for (int c0 = 0; c0 < c; c0 += G) {
      const int s = c0 + g.lane;
      const unsigned m = g.vote(s < c && pid[s] == x);
      if (m) return c0 + __ffs(m) - 1;
    }
    return -1;
  }
  __device__ __forceinline__ int first_free(const Group<G>& g) const {
    for (int c0 = 0; c0 < c; c0 += G) {
      const int s = c0 + g.lane;
      const unsigned m = g.vote(s < c && pid[s] < 0);
      if (m) return c0 + __ffs(m) - 1;
    }
    return -1;
  }
  __device__ __forceinline__ int credit_of(const Group<G>&, int s) const {
    return credit[s];
  }
  __device__ __forceinline__ void put(const Group<G>& g, int s, int x,
                                      int y) {
    if (g.lane == 0) {
      pid[s] = x;
      credit[s] = y;
    }
    g.sync();
  }
  __device__ __forceinline__ void set_credit(const Group<G>& g, int s,
                                             int y) {
    if (g.lane == 0) credit[s] = y;
    g.sync();
  }
  __device__ __forceinline__ void detach(const Group<G>& g, int s) {
    if (g.lane == 0) pid[s] = -1;
    g.sync();
  }
};

// a ring from device memory into shared memory, every copy in flight at
// once (cp.async; the caller waits)
template <int G>
__device__ __forceinline__ void load_ring(int* dst, const int* src, int q,
                                          int lane, bool vec) {
  if (vec) {
    for (int i = 4 * lane; i < q; i += 4 * G)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  } else {
    for (int i = lane; i < q; i += G)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(int));
  }
}

template <int G>
__device__ __forceinline__ void store_ring(int* dst, const int* src, int q,
                                           int lane, bool vec) {
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll 4
    for (int i = lane; i < q / 4; i += G) d4[i] = s4[i];
  } else {
#pragma unroll 4
    for (int i = lane; i < q; i += G) dst[i] = src[i];
  }
}

// The requeue merge of the rows in ``req`` (bits over the group's lanes),
// as the reference's _requeue_merge; returns the new head.  The slow path
// gathers from a copy of the ring in the row's output rings (device
// memory, written for good only at the end).
template <int G>
__device__ __forceinline__ int requeue(const Group<G>& g, const Row& r,
                                       unsigned req, const Ring& ring) {
  const int Q = ring.q;
  const int h = r.head;
  const int n_req = __popc(req);
  const int size2 = wsub(r.tail, h);
  const int nh = wsub(h, n_req);
  const int span = wadd(size2, n_req);
  const int lim = span < Q ? span : Q;
  // away from the int32 edges (or with Q a power of two) the reference's
  // slot offsets from the head are a rotation of the ring
  const bool edge = !ring.pow2 && (h < INT_MIN + 2 * Q + 64 ||
                                   h > INT_MAX - 2 * Q - 64);
  const bool in_req = (req >> g.lane) & 1u;
  g.sync();   // ring writes of earlier commands are visible to every lane

  // -- ranks: ready tickets below each requeued ticket, plus the requeued
  // tickets below it
  const int win = size2 < Q ? size2 : Q;
  const int h0 = ring.mod(h);
  int my_rank = -1;
  for (unsigned bits = req; bits; bits &= bits - 1) {
    const int k = __ffs(bits) - 1;
    const int cm = g.bcast(r.co_mid, k);
    int cnt = 0;
    if (!edge) {
      for (int j = g.lane; j < win; j += G) cnt += r.mid[ring.at(h0, j)] < cm;
    } else {
      for (int s = g.lane; s < Q; s += G)
        cnt += ring.mod(wsub(s, h)) < size2 && r.mid[s] < cm;
    }
    cnt = g.sum(cnt);
    const int fellow = __popc(g.vote(in_req && r.co_mid < cm));
    if (g.lane == k) my_rank = cnt + fellow;
  }
  // every lane learns the ranks (-1: not requeued); req is the same in
  // every lane, so only requeued lanes are asked
  int rk[G];
  int max_rank = -1, same = 0;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    rk[i] = (req >> i) & 1u ? g.bcast(my_rank, i) : -1;
    max_rank = rk[i] > max_rank ? rk[i] : max_rank;
    same += in_req && rk[i] == my_rank;
  }
  const bool distinct = g.vote(same > 1) == 0;
  // what lands at my rank: my row, or with equal ranks the wrapping sum
  // over the rows of that rank, written by the lowest of them
  int lv = r.co_val, ld = wadd(r.co_dc, 1), lm = r.co_mid;
  bool first = in_req;
  if (!distinct) {
    lv = ld = lm = 0;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (!((req >> i) & 1u)) continue;
      const int v = g.bcast(r.co_val, i), d = g.bcast(r.co_dc, i);
      const int m = g.bcast(r.co_mid, i);
      if (rk[i] == my_rank) {
        lv = wadd(lv, v);
        ld = wadd(ld, wadd(d, 1));
        lm = wadd(lm, m);
        if (i < g.lane) first = false;
      }
    }
  }

  // -- the rebuild: destination offset jd from the new head takes the
  // rows landing at jd, or the ready entry at offset jd - (ranks below
  // jd) from the old head.  That source lies at so = jd + (ranks at or
  // above jd) from the new head, never below jd.  It can pass the ring's
  // end (equal ranks, or ranks past the end in a state that holds more
  // than the capacity), onto offset so - Q < n_req: those slots, all in
  // the first chunk, are read into lanes' registers before it writes them
  // (a ring no wider than the group is one chunk, every source read
  // before any slot is written).
  const int top = lim < max_rank + 1 ? lim : max_rank + 1;
  if (!edge) {
    const int nh0 = ring.mod(nh);
    const bool wraps = Q > G && top - 1 + n_req >= Q;
    int wv = 0, wd = 0, wm = 0;
    if (wraps && g.lane < n_req) {
      const int s = ring.at(nh0, g.lane);
      wv = r.buf[s];
      wd = r.dc[s];
      wm = r.mid[s];
    }
    for (int c0 = 0; c0 < top; c0 += G) {
      const int jd = c0 + g.lane;
      bool landed = false;
      int lt = 0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        landed |= rk[i] == jd;
        lt += rk[i] >= 0 && rk[i] < jd;
      }
      const bool mv = jd < top && !landed;
      const int so = jd + n_req - lt;
      const bool past = so >= Q;
      int v = 0, d = 0, m = 0;
      if (mv && !(wraps && past)) {
        const int s = ring.at(nh0, past ? so % Q : so);
        v = r.buf[s];
        d = r.dc[s];
        m = r.mid[s];
      }
      if (wraps) {   // uniform: every lane of the group shuffles
        const int w = mv && past ? so - Q : 0;
        const int pv = g.bcast(wv, w), pd = g.bcast(wd, w);
        const int pm = g.bcast(wm, w);
        if (mv && past) {
          v = pv;
          d = pd;
          m = pm;
        }
      }
      g.sync();
      if (mv) {
        const int t = ring.at(nh0, jd);
        r.buf[t] = v;
        r.dc[t] = d;
        r.mid[t] = m;
      }
      g.sync();
    }
    if (first && my_rank < lim) {
      const int t = ring.at(nh0, my_rank);
      r.buf[t] = lv;
      r.dc[t] = ld;
      r.mid[t] = lm;
    }
  } else {
    for (int s = g.lane; s < Q; s += G) {
      r.sbuf[s] = r.buf[s];
      r.sdc[s] = r.dc[s];
      r.smid[s] = r.mid[s];
    }
    g.sync();
    for (int s0 = 0; s0 < Q; s0 += G) {   // one trip count for the shuffles
      const int s = s0 + g.lane;
      const int jd = ring.mod(wsub(s, nh));
      int lt = 0, at = -1;
#pragma unroll
      for (int i = G - 1; i >= 0; --i) {
        lt += rk[i] >= 0 && rk[i] < jd;
        if (rk[i] == jd) at = i;
      }
      const int src_lane = at < 0 ? 0 : at;
      const int v = g.bcast(lv, src_lane), d = g.bcast(ld, src_lane);
      const int m = g.bcast(lm, src_lane);
      if (s < Q && jd < span) {
        if (at >= 0) {
          r.buf[s] = v;
          r.dc[s] = d;
          r.mid[s] = m;
        } else {
          const int src = ring.mod(wsub(wadd(h, jd), lt));
          r.buf[s] = r.sbuf[src];
          r.dc[s] = r.sdc[src];
          r.mid[s] = r.smid[src];
        }
      }
    }
  }
  g.sync();
  return nh;
}

// SHARED: the ring in shared memory; else in the output rings
template <int G, class Cons, bool SHARED>
__device__ void fold_row(const RaFifoFoldArgs& a, const Layout& lay,
                         const Group<G>& g, long long row, int* sring) {
  const int Q = a.q, K = a.k, C = a.c;
  const Ring ring{Q, (Q & (Q - 1)) == 0};
  const bool is_k = g.lane < K;
  const bool vec = lay.vec != 0;
  Row r;
  r.sbuf = a.out[kBuf] + row * Q;
  r.sdc = a.out[kDc] + row * Q;
  r.smid = a.out[kMid] + row * Q;
  if (SHARED) {
    r.buf = sring;
    r.dc = sring + lay.qs;
    r.mid = sring + 2 * lay.qs;
    load_ring<G>(r.buf, a.in[kBuf] + row * Q, Q, g.lane, vec);
    load_ring<G>(r.dc, a.in[kDc] + row * Q, Q, g.lane, vec);
    load_ring<G>(r.mid, a.in[kMid] + row * Q, Q, g.lane, vec);
    __pipeline_commit();
  } else {   // folded in place in the output rings (Q a power of two)
    r.buf = r.sbuf;
    r.dc = r.sdc;
    r.mid = r.smid;
    for (int i = g.lane; i < Q; i += G) {
      r.buf[i] = a.in[kBuf][row * Q + i];
      r.dc[i] = a.in[kDc][row * Q + i];
      r.mid[i] = a.in[kMid][row * Q + i];
    }
  }
  const long long ko = row * K + g.lane;
  r.co_id = is_k ? a.in[kCoId][ko] : -1;
  r.co_val = is_k ? a.in[kCoVal][ko] : 0;
  r.co_dc = is_k ? a.in[kCoDc][ko] : 0;
  r.co_mid = is_k ? a.in[kCoMid][ko] : 0;
  r.co_owner = is_k ? a.in[kCoOwner][ko] : 0;
  Cons cons;
  cons.load(g, a, row);
  r.head = a.in[kHead][row];
  r.tail = a.in[kTail][row];
  r.next_id = a.in[kNextId][row];
  r.next_mid = a.in[kNextMid][row];
  r.n_dropped = a.in[kNDropped][row];

  const long long n = row / a.p, p = row % a.p;
  const int* cmd0 = a.cmds + n * a.cmd_stride[0] + p * a.cmd_stride[1];
  const bool* mask0 = a.mask + n * a.mask_stride[0] + p * a.mask_stride[1];
  const long long cs = a.cmd_stride[3];
  unsigned live = g.vote(is_k && r.co_id >= 0);   // co_id >= 0, by row
  const unsigned kmask = K >= 32 ? 0xffffffffu : (1u << K) - 1;
  // lane l holds command i0 + l of the batch; the next batch loads while
  // this one folds
  int op_n = 0, x_n = 0, y_n = 0;
  bool m_n = false;
  auto fetch = [&](int i0) {
    const int i = i0 + g.lane < a.a ? i0 + g.lane : a.a - 1;
    const int* c = cmd0 + i * a.cmd_stride[2];
    m_n = i0 + g.lane < a.a && mask0[i * a.mask_stride[2]];
    op_n = __ldg(c);
    x_n = __ldg(c + cs);
    y_n = __ldg(c + 2 * cs);
  };
  if (a.a > 0) fetch(0);
  __pipeline_wait_prior(0);
  g.sync();

  for (int i0 = 0; i0 < a.a; i0 += G) {
    const int op_l = op_n, x_l = x_n, y_l = y_n;
    const bool m_l = m_n;
    if (i0 + G < a.a) fetch(i0 + G);
    for (unsigned todo = g.vote(m_l); todo; todo &= todo - 1) {
      const int j = __ffs(todo) - 1;
      const int op = g.bcast(op_l, j), x = g.bcast(x_l, j);
      const int size = wsub(r.tail, r.head);
      const bool empty = size <= 0;
      unsigned req = 0, release = 0;   // rows to requeue, rows to free
      switch (op) {
        case 1: {   // enqueue, under either overflow policy
          const bool full = wadd(size, __popc(live)) >= Q;
          const bool drop = a.drop_head && full && size > 0;
          if (!full || drop) {
            if (g.lane == 0) {
              const int t = ring.mod(r.tail);
              r.buf[t] = x;
              r.dc[t] = 0;
              r.mid[t] = r.next_mid;
            }
            r.next_mid = wadd(r.next_mid, 1);
            r.tail = wadd(r.tail, 1);
            if (drop) {
              r.head = wadd(r.head, 1);
              r.n_dropped = wadd(r.n_dropped, 1);
            }
          }
          break;
        }
        case 2:     // dequeue settled
          if (!empty) r.head = wadd(r.head, 1);
          break;
        case 3:     // dequeue unsettled (anonymous), consumer checkout
        case 10: {
          const unsigned free = ~live & kmask;
          bool ok = !empty && free != 0;
          int owner = C;
          if (op == 10) {
            const int found = cons.find(g, x);
            const int ps = found < 0 ? 0 : found;
            const int used = __popc(g.vote(r.co_owner == ps) & live);
            const int credit = cons.credit_of(g, ps);
            ok = ok && found >= 0 && used < credit;
            owner = ps;
          }
          if (ok) {
            const int fs = __ffs(free) - 1;
            g.sync();
            if (g.lane == fs) {
              const int hs = ring.mod(r.head);
              r.co_val = r.buf[hs];
              r.co_dc = r.dc[hs];
              r.co_mid = r.mid[hs];
              r.co_owner = owner;
              r.co_id = r.next_id;
            }
            if (r.next_id >= 0) live |= 1u << fs;   // a wrapped id is free
            r.next_id = wadd(r.next_id, 1);
            r.head = wadd(r.head, 1);
          }
          break;
        }
        case 4:     // settle, return
        case 5: {
          const unsigned m = x >= 0 ? g.vote(is_k && r.co_id == x) : 0u;
          release = m & (0u - m);     // the first match
          req = op == 5 ? release : 0u;
          break;
        }
        case 6:     // purge
          r.head = r.tail;
          break;
        case 7: {   // attach, or a new credit for an attached consumer
          const int found = cons.find(g, x);
          const int s = found >= 0 ? found : cons.first_free(g);
          if (s >= 0) cons.put(g, s, x, g.bcast(y_l, j));
          break;
        }
        case 8:     // cancel, down: requeue what the consumer holds
        case 9: {
          const int ps = cons.find(g, x);
          if (ps >= 0) {
            req = release = g.vote(r.co_owner == ps) & live;
            cons.detach(g, ps);
          }
          break;
        }
        case 11: {  // set credit
          const int ps = cons.find(g, x);
          if (ps >= 0) cons.set_credit(g, ps, g.bcast(y_l, j));
          break;
        }
        default:    // noop, unknown ops
          break;
      }
      // a return or a cancel: the merge reads the table as it was, then
      // the rows are freed
      if (req) r.head = requeue<G>(g, r, req, ring);
      if ((release >> g.lane) & 1u) r.co_id = -1;
      live &= ~release;
    }
  }

  if (SHARED) {
    g.sync();
    store_ring<G>(r.sbuf, r.buf, Q, g.lane, vec);
    store_ring<G>(r.sdc, r.dc, Q, g.lane, vec);
    store_ring<G>(r.smid, r.mid, Q, g.lane, vec);
  }
  if (is_k) {
    a.out[kCoId][ko] = r.co_id;
    a.out[kCoVal][ko] = r.co_val;
    a.out[kCoDc][ko] = r.co_dc;
    a.out[kCoMid][ko] = r.co_mid;
    a.out[kCoOwner][ko] = r.co_owner;
  }
  cons.store(g, a, row);
  if (g.lane == 0) {
    a.out[kHead][row] = r.head;
    a.out[kTail][row] = r.tail;
    a.out[kNextId][row] = r.next_id;
    a.out[kNextMid][row] = r.next_mid;
    a.out[kNDropped][row] = r.n_dropped;
  }
}

// 16 one-warp blocks an SM caps a thread at 128 registers: left to
// itself, ptxas picks fewer and spills inside the command loop
template <int G, class Cons, bool SHARED>
__global__ void __launch_bounds__(32, 16)
fifo_fold_kernel(const RaFifoFoldArgs a, const Layout lay) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int gi = threadIdx.x / G;   // the group, one row each
  const long long row = (long long)blockIdx.x * lay.rows_per_block + gi;
  if (gi >= lay.rows_per_block || row >= (long long)a.n * a.p) return;
  const int wl = threadIdx.x % 32;
  Group<G> g;
  g.base = wl / G * G;
  g.lane = wl % G;
  g.mask = Group<G>::kLow << g.base;
  fold_row<G, Cons, SHARED>(a, lay, g, row, smem + gi * lay.row_ints);
}

// rows a block, padded ring stride and shared bytes for group size ``g``.
// A block is one warp: small blocks pack the most rows into an SM's
// shared memory (17 blocks of four rows at Q = 256).  A ring too long for
// a warp's rows leaves groups idle; one past kMaxSharedRing stays in
// device memory.
Layout choose_layout(const RaFifoFoldArgs& a, int g, size_t* smem) {
  Layout lay;
  lay.shared = a.q <= kMaxSharedRing;
  if (!lay.shared) {
    lay.rows_per_block = 32 / g;
    lay.row_ints = lay.qs = lay.vec = 0;
    *smem = 0;
    return lay;
  }
  // pad the ring's stride to G mod 32 banks: the groups of a warp, whose
  // heads usually agree, then read and write different banks
  lay.qs = (a.q + 31) / 32 * 32 + g % 32;
  lay.row_ints = 3 * lay.qs;
  const uintptr_t align =
      (uintptr_t)a.in[kBuf] | (uintptr_t)a.in[kDc] | (uintptr_t)a.in[kMid] |
      (uintptr_t)a.out[kBuf] | (uintptr_t)a.out[kDc] | (uintptr_t)a.out[kMid];
  lay.vec = a.q % 4 == 0 && (align & 15) == 0;
  const size_t row_bytes = (size_t)lay.row_ints * sizeof(int);
  const int fit = (int)(kSmemPerBlock / row_bytes);
  lay.rows_per_block = 32 / g < fit ? 32 / g : fit;
  *smem = row_bytes * lay.rows_per_block;
  return lay;
}

template <int G, class Cons>
int launch(const RaFifoFoldArgs& a, cudaStream_t stream) {
  size_t smem = 0;
  const Layout lay = choose_layout(a, G, &smem);
  if (lay.rows_per_block < 1) return (int)cudaErrorInvalidValue;
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
        fifo_fold_kernel<G, Cons, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = smem;
  }
  const long long rows = (long long)a.n * a.p;
  const unsigned blocks =
      (unsigned)((rows + lay.rows_per_block - 1) / lay.rows_per_block);
  if (lay.shared)
    fifo_fold_kernel<G, Cons, true><<<blocks, 32, smem, stream>>>(a, lay);
  else
    fifo_fold_kernel<G, Cons, false><<<blocks, 32, 0, stream>>>(a, lay);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ra_fifo_fold_args_size() {
  return (int)sizeof(RaFifoFoldArgs);
}

extern "C" int ra_fifo_fold(const RaFifoFoldArgs* a, void* stream) {
  const long long rows = (long long)a->n * a->p;
  if (rows <= 0) return (int)cudaSuccess;
  if (a->k < 1 || a->k > kMaxCheckout || a->c < 1 || a->q < 1 ||
      (a->q > kMaxSharedRing && (a->q & (a->q - 1)) != 0))
    return (int)cudaErrorInvalidValue;
  const int width = a->k > a->c ? a->k : a->c;
  const cudaStream_t s = (cudaStream_t)stream;
  if (width <= 8) return launch<8, RegConsumers<8>>(*a, s);
  if (width <= 16) return launch<16, RegConsumers<16>>(*a, s);
  if (width <= 32) return launch<32, RegConsumers<32>>(*a, s);
  return launch<32, MemConsumers<32>>(*a, s);
}
