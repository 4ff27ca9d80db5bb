// Count-based quorum selection, shared by the port's kernels
// (quorum.cu, commit_phase.cu).
//
// For one lane with P member slots, `val[i]` the member values (match or
// confirmed query indexes) and bit i of `voters` set for voting members:
//   needed    = popcount(voters) / 2 + 1
//   support_i = #{voters j : val[j] >= val[i]}
//   agreed    = max(0, max{val[i] : voter i, support_i >= needed})
// which is the (n/2)-th element (0-based) of the voters' values sorted
// descending, clamped to 0: the voter-masked median of
// ra_tpu_torch/ops/quorum.py::agreed_commit without a sort.  Lanes with
// no voter give 0.  Non-voters' values are never read as candidates or
// counted, so the caller may leave anything there.
//
// P is a template constant: the O(P^2) compare loops unroll to P x P, and
// every index into `val` is a constant, so `val` lives in registers.
#pragma once

template <int P>
__device__ __forceinline__ int ra_quorum_select(const int (&val)[P],
                                                unsigned voters) {
  const int needed = __popc(voters) / 2 + 1;
  int agreed = -1;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    int support = 0;
#pragma unroll
    for (int j = 0; j < P; ++j)
      support += ((voters >> j) & 1u) && val[j] >= val[i] ? 1 : 0;
    if (((voters >> i) & 1u) && support >= needed && val[i] > agreed)
      agreed = val[i];
  }
  return agreed > 0 ? agreed : 0;
}
