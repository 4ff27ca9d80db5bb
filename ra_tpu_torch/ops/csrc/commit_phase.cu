// The commit phase of a lockstep step, fused into one kernel for Hopper
// (sm_90a).  It replaces the Pallas TPU kernel
// ra_tpu/ops/pallas_quorum.py::_kernel together with the XLA around it in
// ra_tpu/engine/lockstep.py:450-535 (phases 4, 4a and 4b of _step).  The
// plain torch version is ra_tpu_torch/ops/commit_phase.py::commit_phase;
// the two are equal on every output, dtypes included.
//
// Per lane (one Raft cluster of P member slots), on chip:
//   4.  reply fold  match = active ? max(match0, last_written) : match0,
//       next = active ? last_index + 1 : next0; the commit quorum (the
//       count-based selection of quorum_select.cuh over match) with the
//       §5.4.2 term gate against the OLD leader commit; the broadcast
//       commit = active ? max(min(new, last_index), commit) : commit;
//       delta and total_committed.
//   4a. read_clock + 1; the lease's counted quorum of active voters
//       (votes >= voters/2 + 1), revoked on a won election, extended to
//       read_clock + lease_ttl under a live leader; read registration
//       with min(n_read, Kr).
//   4b. the query counter bump, the election reset of peer_query, the
//       members' confirmations, and the second selection: query_agreed.
//
// Bound: memory.  Every input is read once and every output written once:
// [N,P] 6 int32 + 2 bool in, 4 int32 out (42P bytes a lane); [N] 11 int32
// + 3 bool in, 12 int32 + 2 bool out (97 bytes a lane).  At P = 5 that is
// 307 B a lane, 3.07 MB at N = 10,000: 0.92 us at 3.35 TB/s.  The two
// selections are 2P^2 compares a lane, far under the card's integer rate.
//
// Design, for that bound and for the launch cost that dominates at it:
//   * One launch for the whole phase instead of ~50 small kernels: every
//     intermediate (the folded match, the leader commits, the lease and
//     read flags, the confirmed query row) stays on chip.
//   * A block takes kLanesPerBlock = 128 lanes (79 blocks at N = 10,000,
//     so every one of the 132 SMs has work).  64 lanes a block (157 blocks)
//     was measured against it back to back at N = 10,000, P = 5 on the
//     H100 and was slower by under 1% (PERF.md), so 128 is fixed here.
//   * Coalesced rows.  The block's [128,P] tile of each [N,P] tensor is
//     contiguous in device memory; the block copies it to shared memory
//     with 16-byte vector loads (a scalar tail for the ragged end; tile.cuh,
//     shared with quorum.cu), then
//     each thread works on its own row there.  int32 rows are stored with
//     an odd stride (P | 1), so a warp's row reads hit 32 different banks.
//     The four [N,P] outputs are written in place over their inputs' rows
//     in shared memory and leave the same way, with 16-byte stores.  [N]
//     values are one coalesced 4-byte (or 1-byte) access per thread; the
//     inputs are all loaded into registers before the tile copies, so the
//     kernel waits on device memory about once for its loads, not once
//     per value (the outputs' stores would otherwise order the loads).
//   * Templated on P (1..16, a host-side switch): the selection loops are
//     P x P (25 compares at P = 5, not 256) and only the row being selected
//     is held in registers (P values); the rest stays in shared memory.
//   * It reads only its inputs and writes only its fresh outputs (the
//     wrapper allocates them; a step's state tensors alias its aux, so an
//     input is never written), allocates nothing, never synchronises, and
//     launches on the caller's stream: safe to capture in a CUDA graph.
// Integer adds wrap like torch's int32 arithmetic.  leader_slot must lie
// in [0, P), as the engine keeps it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum_select.cuh"
#include "tile.cuh"

typedef unsigned char u8;

// Lanes a block: one thread a lane.
constexpr int kLanesPerBlock = 128;

// One pointer per tensor, in the order of commit_phase.py's INPUTS and
// CommitPhase (the ctypes Structure _Args mirrors it field for field).
struct RaCommitPhaseArgs {
  // inputs [N,P]
  const int* match0;
  const int* next0;
  const int* last_index;
  const int* last_written;
  const int* commit;
  const int* peer_query;
  const u8* active;
  const u8* voter;
  // inputs [N]
  const int* term_start;
  const int* leader_slot;
  const u8* elect_ok;
  const u8* leader_up;
  const int* total_committed;
  const int* read_clock;
  const int* lease_until;
  const int* n_read;
  const int* read_n;
  const int* read_ix;
  const int* read_reg;
  const u8* query_mask;
  const int* query_index;
  const int* read_tok;
  // outputs [N,P]
  int* out_match;
  int* out_next_index;
  int* out_commit;
  int* out_peer_query;
  // outputs [N]
  int* out_total_committed;
  int* out_delta;
  int* out_leader_commit;
  int* out_read_clock;
  int* out_lease_until;
  u8* out_lease_ok;
  u8* out_acc_lane;
  int* out_r_shed_now;
  int* out_read_ix;
  int* out_read_reg;
  int* out_read_n1;
  int* out_query_index;
  int* out_read_tok;
  int* out_query_agreed;
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

template <int P>
struct CommitPhaseTiles {
  static constexpr int S = P | 1;            // int32 row stride (odd)
  static constexpr int kInt = kLanesPerBlock * S;  // ints in an int32 tile
  static constexpr int kByte = kLanesPerBlock * P;  // bytes in a bool tile
  static constexpr size_t kSmem = 6 * kInt * sizeof(int) + 2 * kByte;
};

template <int P>
__global__ void __launch_bounds__(kLanesPerBlock)
commit_phase_kernel(const RaCommitPhaseArgs a, int n, int lease_ttl, int kr,
                    int supports_read) {
  using T = CommitPhaseTiles<P>;
  constexpr int S = T::S;
  extern __shared__ int4 smem[];
  int* s_m = reinterpret_cast<int*>(smem);   // match0, then match
  int* s_nx = s_m + T::kInt;                 // next0, then next_index
  int* s_li = s_nx + T::kInt;                // last_index
  int* s_lw = s_li + T::kInt;                // last_written
  int* s_c = s_lw + T::kInt;                 // commit, then the new commit
  int* s_pq = s_c + T::kInt;                 // peer_query, then the new one
  u8* s_act = reinterpret_cast<u8*>(s_pq + T::kInt);
  u8* s_vot = s_act + T::kByte;

  const int lane0 = blockIdx.x * kLanesPerBlock;
  const int rows = min(kLanesPerBlock, n - lane0);
  const int t = threadIdx.x;
  const int lane = lane0 + t;
  const bool live = t < rows;

  // The lane's [N] inputs go to registers first: their loads are in flight
  // while the block copies its tiles, and no store below can be taken to
  // alias them (which would serialise load after store).
  int leader_slot = 0, term_start = 0, total_committed = 0, read_clock = 0,
      lease_until = 0, n_read = 0, read_n = 0, read_ix = 0, read_reg = 0,
      query_index = 0, read_tok = 0;
  bool elect_ok = false, leader_up = false, query_mask = false;
  if (live) {
    leader_slot = a.leader_slot[lane];
    term_start = a.term_start[lane];
    elect_ok = a.elect_ok[lane] != 0;
    leader_up = a.leader_up[lane] != 0;
    total_committed = a.total_committed[lane];
    read_clock = a.read_clock[lane];
    lease_until = a.lease_until[lane];
    n_read = a.n_read[lane];
    read_n = a.read_n[lane];
    read_ix = a.read_ix[lane];
    read_reg = a.read_reg[lane];
    query_mask = a.query_mask[lane] != 0;
    query_index = a.query_index[lane];
    read_tok = a.read_tok[lane];
  }

  const int count = rows * P;
  const size_t off = (size_t)lane0 * P;
  load_tile<int, P, S>(s_m, a.match0 + off, count);
  load_tile<int, P, S>(s_nx, a.next0 + off, count);
  load_tile<int, P, S>(s_li, a.last_index + off, count);
  load_tile<int, P, S>(s_lw, a.last_written + off, count);
  load_tile<int, P, S>(s_c, a.commit + off, count);
  load_tile<int, P, S>(s_pq, a.peer_query + off, count);
  load_tile<u8, P, P>(s_act, a.active + off, count);
  load_tile<u8, P, P>(s_vot, a.voter + off, count);
  __syncthreads();

  if (live) {
    int* m = s_m + t * S;
    int* nx = s_nx + t * S;
    const int* li = s_li + t * S;
    const int* lw = s_lw + t * S;
    int* c = s_c + t * S;
    int* pq = s_pq + t * S;
    unsigned act = 0, vot = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      act |= s_act[t * P + i] ? 1u << i : 0u;
      vot |= s_vot[t * P + i] ? 1u << i : 0u;
    }

    // -- 4. reply fold, commit quorum, commit broadcast --------------------
    int val[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const bool on = (act >> i) & 1u;
      const int x = on ? max(m[i], lw[i]) : m[i];
      val[i] = x;
      m[i] = x;
      if (on) nx[i] = wrap_add(li[i], 1);
    }
    const int lc0 = c[leader_slot];
    const int agreed = ra_quorum_select<P>(val, vot);
    const int new_lc = (agreed > lc0 && agreed >= term_start) ? agreed : lc0;
#pragma unroll
    for (int i = 0; i < P; ++i)
      if ((act >> i) & 1u) c[i] = max(min(new_lc, li[i]), c[i]);
    const int lc1 = c[leader_slot];
    const int delta = wrap_sub(lc1, lc0);

    // -- 4a. lease grant/expiry, read-batch registration -------------------
    const int rc = wrap_add(read_clock, 1);
    const bool lease_q = __popc(act & vot) >= __popc(vot) / 2 + 1;
    if (elect_ok) lease_until = 0;
    if (lease_q && leader_up)
      lease_until = max(lease_until, wrap_add(rc, lease_ttl));
    const bool acc = supports_read && n_read > 0 && leader_up && read_n == 0;
    const int r_acc = acc ? min(n_read, kr) : 0;

    // -- 4b. consistent-query heartbeat quorum -----------------------------
    const int qi = wrap_add(query_index, query_mask || acc ? 1 : 0);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int x = ((act >> i) & 1u) ? qi : (elect_ok ? 0 : pq[i]);
      val[i] = x;
      pq[i] = x;
    }

    a.out_total_committed[lane] = wrap_add(total_committed, delta);
    a.out_delta[lane] = delta;
    a.out_leader_commit[lane] = lc1;
    a.out_read_clock[lane] = rc;
    a.out_lease_until[lane] = lease_until;
    a.out_lease_ok[lane] = rc < lease_until ? 1 : 0;
    a.out_acc_lane[lane] = acc ? 1 : 0;
    a.out_r_shed_now[lane] = wrap_sub(n_read, r_acc);
    a.out_read_ix[lane] = acc ? lc0 : read_ix;
    a.out_read_reg[lane] = acc ? rc : read_reg;
    a.out_read_n1[lane] = acc ? r_acc : read_n;
    a.out_query_index[lane] = qi;
    a.out_read_tok[lane] = acc ? qi : read_tok;
    a.out_query_agreed[lane] = ra_quorum_select<P>(val, vot);
  }
  __syncthreads();

  store_tile<P, S>(a.out_match + off, s_m, count);
  store_tile<P, S>(a.out_next_index + off, s_nx, count);
  store_tile<P, S>(a.out_commit + off, s_c, count);
  store_tile<P, S>(a.out_peer_query + off, s_pq, count);
}

template <int P>
static int launch(const RaCommitPhaseArgs& a, int n, int lease_ttl, int kr,
                  int supports_read, cudaStream_t stream) {
  const size_t smem = CommitPhaseTiles<P>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        commit_phase_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kLanesPerBlock - 1) / kLanesPerBlock;
  commit_phase_kernel<P><<<blocks, kLanesPerBlock, smem, stream>>>(
      a, n, lease_ttl, kr, supports_read);
  return (int)cudaGetLastError();
}

extern "C" int ra_commit_phase_args_size() {
  return (int)sizeof(RaCommitPhaseArgs);
}

extern "C" int ra_commit_phase(const RaCommitPhaseArgs* a, int n, int p,
                               int lease_ttl, int kr, int supports_read,
                               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p) {
#define RA_CASE(PP) \
  case PP:          \
    return launch<PP>(*a, n, lease_ttl, kr, supports_read, s);
    RA_CASE(1) RA_CASE(2) RA_CASE(3) RA_CASE(4)
    RA_CASE(5) RA_CASE(6) RA_CASE(7) RA_CASE(8)
    RA_CASE(9) RA_CASE(10) RA_CASE(11) RA_CASE(12)
    RA_CASE(13) RA_CASE(14) RA_CASE(15) RA_CASE(16)
#undef RA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
