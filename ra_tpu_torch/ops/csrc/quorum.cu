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
//
// Design: one thread per lane, 256 threads a block, the ragged edge
// masked.  A thread holds its lane's masked[16] and a voter bitmask in
// registers and runs the selection of quorum_select.cuh unrolled over the
// 16-slot maximum (every index a constant).  Lanes are independent: no
// shared memory, no atomics.  The engine's step no longer launches this
// kernel: commit_phase.cu fuses the same selection into the whole commit
// phase.  It stays as the counterpart of the public evaluate_quorum API.
//
// Bound: memory.  The function must move N*(4P + P + 12) bytes (match
// int32 and voter uint8 [N,P]; commit, term_start, out int32 [N]):
// ~370 KB at N = 10,000, P = 5, ~0.11 us at 3.35 TB/s.  At that size a
// launch costs more than the bytes, so the kernel is launch-bound; fusing
// it into a larger step kernel is the way past that.
#include <cuda_runtime.h>

#include "quorum_select.cuh"

#define RA_MAX_MEMBERS 16

__global__ void __launch_bounds__(256)
evaluate_quorum_kernel(const int* __restrict__ match,
                       const unsigned char* __restrict__ voter,
                       const int* __restrict__ commit,
                       const int* __restrict__ term_start,
                       int* __restrict__ out, int n, int p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int* m = match + (size_t)lane * p;
  const unsigned char* v = voter + (size_t)lane * p;

  int masked[RA_MAX_MEMBERS];
  unsigned voters = 0;
#pragma unroll
  for (int i = 0; i < RA_MAX_MEMBERS; ++i) {
    const bool vi = i < p && v[i] != 0;
    voters |= vi ? 1u << i : 0u;
    masked[i] = vi ? m[i] : -1;
  }
  const int agreed = ra_quorum_select<RA_MAX_MEMBERS>(masked, voters);

  const int c = commit[lane];
  out[lane] = (agreed > c && agreed >= term_start[lane]) ? agreed : c;
}

extern "C" int ra_evaluate_quorum(const int* match, const unsigned char* voter,
                                  const int* commit, const int* term_start,
                                  int* out, int n, int p, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  evaluate_quorum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      match, voter, commit, term_start, out, n, p);
  return (int)cudaGetLastError();
}
