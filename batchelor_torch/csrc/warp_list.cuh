// A warp's sorted list of the best (value, column) keys, shared by K2
// (topk_rows.cu) and K5 (knn_exact.cu).
//
// Entry p of the list lives in lane p % 32 of register slot p / 32 (S = 1
// slot for k <= 32, 2 for k <= 64). The list is sorted by value, largest
// first; a key goes in at its place by a ballot over the list, and a
// __shfl_up moves the entries behind it down one (the last drops out).
#pragma once

#include <cuda_runtime.h>

namespace warp_list {

constexpr unsigned kFull = 0xffffffffu;

// Value of list entry k - 1, in every lane.
template <int S>
__device__ __forceinline__ float kth_value(const float (&ev)[S], int k) {
  float t = ev[0];
  if constexpr (S == 2) t = k > 32 ? ev[1] : ev[0];
  return __shfl_sync(kFull, t, (k - 1) & 31);
}

// Column of list entry k - 1, in every lane.
template <int S>
__device__ __forceinline__ int kth_column(const int (&ec)[S], int k) {
  int t = ec[0];
  if constexpr (S == 2) t = k > 32 ? ec[1] : ec[0];
  return __shfl_sync(kFull, t, (k - 1) & 31);
}

// Place of a key whose column is above every column in the list: behind
// each entry whose value is not smaller, so equal values keep the lower
// column without comparing columns.
template <int S>
__device__ __forceinline__ int place_after_ties(const float (&ev)[S], float v) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) pos += __popc(__ballot_sync(kFull, ev[s] >= v));
  return pos;
}

// Place of a key of any column in the order (value descending, column
// ascending): behind each entry that is larger, or equal with a lower column.
template <int S>
__device__ __forceinline__ int place_ordered(const float (&ev)[S], const int (&ec)[S], float v,
                                             int col) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    pos += __popc(__ballot_sync(kFull, ev[s] > v || (ev[s] == v && ec[s] < col)));
  return pos;
}

// Whether (v, col) goes before (tv, tc) in that order.
__device__ __forceinline__ bool beats(float v, int col, float tv, int tc) {
  return v > tv || (v == tv && col < tc);
}

// Puts (v, col) at entry `pos` and moves the entries from there down one.
template <int S>
__device__ __forceinline__ void insert_at(float (&ev)[S], int (&ec)[S], float v, int col, int pos,
                                          int lane) {
  float uv[S];
  int uc[S];
  uv[0] = __shfl_up_sync(kFull, ev[0], 1);
  uc[0] = __shfl_up_sync(kFull, ec[0], 1);
  if constexpr (S == 2) {                 // slot 1's lane 0 takes slot 0's lane 31
    const int from = (lane + 31) & 31;
    uv[1] = __shfl_sync(kFull, lane == 31 ? ev[0] : ev[1], from);
    uc[1] = __shfl_sync(kFull, lane == 31 ? ec[0] : ec[1], from);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int p = 32 * s + lane;
    if (p > pos) {
      ev[s] = uv[s];
      ec[s] = uc[s];
    } else if (p == pos) {
      ev[s] = v;
      ec[s] = col;
    }
  }
}

}  // namespace warp_list
