// Commit-quorum kernel for Hopper (sm_90a): the CUDA counterpart of the
// Pallas TPU kernel ra_tpu/ops/pallas_quorum.py::_kernel.
//
// Per lane (one Raft cluster), with P member slots:
//   masked_i  = voter_i ? match_i : -1
//   needed    = #voters / 2 + 1
//   support_i = #{voters j : masked_j >= masked_i}
//   agreed    = max(0, max{masked_i : voter_i && support_i >= needed})
//   out       = (agreed > commit && agreed >= term_start) ? agreed : commit
// i.e. the voter-masked majority match index found by count-based
// selection (no sort), the §5.4.2 term gate, and commit never moving back.
// The plain torch version is ra_tpu_torch/ops/quorum.py::evaluate_quorum.
// The engine's step does not launch this kernel: commit_phase.cu fuses the
// same selection into the whole commit phase.  It serves the public
// evaluate_quorum API.
//
// Bound: memory.  The function must move N*(4P + P + 12) bytes (match
// int32 and voter uint8 [N,P]; commit, term_start, out int32 [N]):
// ~370 KB at N = 10,000, P = 5, ~0.11 us at 3.35 TB/s.  At that size a
// launch costs more than the bytes, so the kernel's floor is the launch
// (chip_smoke.py times ra_empty_launch below, an empty kernel at the same
// grid, back to back beside it).
//
// Design, after commit_phase.cu:
//  * Templated on P (1..16, a host-side switch): the selection of
//    quorum_select.cuh unrolls P x P (25 compares a lane at P = 5).
//  * kLanes = 64 lanes a block, one thread a lane: 157 blocks at
//    N = 10,000, so every one of the 132 SMs has work.
//  * The block's [64,P] match and voter tiles are contiguous in device
//    memory; they move to shared memory with 16-byte loads (a scalar tail
//    at the ragged end; tile.cuh), int32 rows at an odd stride (P | 1) so
//    that a warp reading one row a thread hits 32 banks.  The lane's
//    commit and term start load into registers before the tiles, and
//    `out` is written once.
// It allocates nothing, never synchronises, and launches on the caller's
// stream, so a CUDA graph can capture it.
#include <cuda_runtime.h>

#include "quorum_select.cuh"
#include "tile.cuh"

namespace {

constexpr int kLanes = 64;  // lanes a block, one thread a lane

template <int P>
__global__ void __launch_bounds__(kLanes)
evaluate_quorum_kernel(const int* __restrict__ match,
                       const unsigned char* __restrict__ voter,
                       const int* __restrict__ commit,
                       const int* __restrict__ term_start,
                       int* __restrict__ out, int n) {
  constexpr int S = P | 1;
  __shared__ __align__(16) int s_m[kLanes * S];
  __shared__ __align__(16) unsigned char s_v[kLanes * P];
  const int lane0 = blockIdx.x * kLanes;
  const int rows = min(kLanes, n - lane0);
  const int t = threadIdx.x, lane = lane0 + t;
  const bool live = t < rows;
  int c = 0, ts = 0;
  if (live) {
    c = commit[lane];
    ts = term_start[lane];
  }
  const size_t off = (size_t)lane0 * P;
  load_tile<int, P, S>(s_m, match + off, rows * P);
  load_tile<unsigned char, P, P>(s_v, voter + off, rows * P);
  __syncthreads();
  if (!live) return;
  // non-voters' values are never read by the selection
  int val[P];
  unsigned voters = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    voters |= s_v[t * P + i] ? 1u << i : 0u;
    val[i] = s_m[t * S + i];
  }
  const int agreed = ra_quorum_select<P>(val, voters);
  out[lane] = (agreed > c && agreed >= ts) ? agreed : c;
}

template <int P>
int launch(const int* match, const unsigned char* voter, const int* commit,
           const int* term_start, int* out, int n, cudaStream_t stream) {
  const int blocks = (n + kLanes - 1) / kLanes;
  evaluate_quorum_kernel<P><<<blocks, kLanes, 0, stream>>>(
      match, voter, commit, term_start, out, n);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int ra_evaluate_quorum(const int* match, const unsigned char* voter,
                                  const int* commit, const int* term_start,
                                  int* out, int n, int p, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p) {
#define RA_CASE(PP) \
  case PP:          \
    return launch<PP>(match, voter, commit, term_start, out, n, s);
    RA_CASE(1) RA_CASE(2) RA_CASE(3) RA_CASE(4)
    RA_CASE(5) RA_CASE(6) RA_CASE(7) RA_CASE(8)
    RA_CASE(9) RA_CASE(10) RA_CASE(11) RA_CASE(12)
    RA_CASE(13) RA_CASE(14) RA_CASE(15) RA_CASE(16)
#undef RA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// An empty kernel of `blocks` x `threads` on `stream`: the launch floor
// that chip_smoke.py times back to back beside the kernels.
extern "C" int ra_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
