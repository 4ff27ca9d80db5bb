// Copies of a block's [lanes, P] tile between device memory and shared
// memory, shared by the port's per-lane kernels (commit_phase.cu,
// quorum.cu).
//
// The tile of a block is the contiguous run of its lanes' rows, `count`
// elements from `g`.  It moves with 16-byte accesses where the run is
// aligned (neighbouring threads on neighbouring 16 bytes), then a scalar
// tail for the ragged end.  In shared memory an int32 tile may keep its
// rows S apart (S odd, so that a warp reading one row a thread hits 32
// banks); a byte tile keeps S = P.  Every thread of the block takes part.
#pragma once

#include <stdint.h>

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// Element e of a contiguous [rows,P] tile at its place in shared memory,
// whose rows are S apart.
template <int P, int S>
__device__ __forceinline__ int tile_slot(int e) {
  if constexpr (S == P)
    return e;
  else
    return (e / P) * S + e % P;
}

// Device memory -> shared memory, `count` elements of type T (int or u8),
// 16 bytes a thread where the source is aligned, then the ragged tail.
template <typename T, int P, int S>
__device__ __forceinline__ void load_tile(T* __restrict__ s,
                                          const T* __restrict__ g,
                                          int count) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (aligned16(g)) {
    const int nv = count / V;
    const int4* gv = reinterpret_cast<const int4*>(g);
    for (int q = threadIdx.x; q < nv; q += blockDim.x) {
      const int4 x = gv[q];
      if constexpr (S == P) {
        reinterpret_cast<int4*>(s)[q] = x;
      } else {
        static_assert(sizeof(T) == 4, "padded rows are int32 tiles only");
        s[tile_slot<P, S>(q * 4)] = x.x;
        s[tile_slot<P, S>(q * 4 + 1)] = x.y;
        s[tile_slot<P, S>(q * 4 + 2)] = x.z;
        s[tile_slot<P, S>(q * 4 + 3)] = x.w;
      }
    }
    done = nv * V;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x)
    s[tile_slot<P, S>(e)] = g[e];
}

// Shared memory -> device memory, the inverse of load_tile for int tiles.
template <int P, int S>
__device__ __forceinline__ void store_tile(int* __restrict__ g,
                                           const int* __restrict__ s,
                                           int count) {
  int done = 0;
  if (aligned16(g)) {
    const int nv = count / 4;
    int4* gv = reinterpret_cast<int4*>(g);
    for (int q = threadIdx.x; q < nv; q += blockDim.x) {
      int4 x;
      if constexpr (S == P) {
        x = reinterpret_cast<const int4*>(s)[q];
      } else {
        x.x = s[tile_slot<P, S>(q * 4)];
        x.y = s[tile_slot<P, S>(q * 4 + 1)];
        x.z = s[tile_slot<P, S>(q * 4 + 2)];
        x.w = s[tile_slot<P, S>(q * 4 + 3)];
      }
      gv[q] = x;
    }
    done = nv * 4;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x)
    g[e] = s[tile_slot<P, S>(e)];
}
