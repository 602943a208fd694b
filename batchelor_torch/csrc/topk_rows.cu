// Row-wise top-k by one warp per row that streams the row once, for Hopper
// (sm_90a).
//
// Replaces: batchelor_tpu/ops/topk_pallas.py, _topk_kernel (called through
// topk_rows).
//
// Contract: for each row of an (n, w) fp32 matrix, the k <= 64 largest
// values in descending order and their int32 columns. Ties go to the lower
// column. The k columns are distinct, also when fewer than k finite entries
// remain (the rule of lax.top_k). Rows must hold no NaN. Any width w >= k.
//
// Bound on this card: bytes. Each row is read once (n * w * 4 bytes) and
// n * k values and columns are written; at (100352, 3136) that is 1.26 GB,
// about 0.38 ms at 3.35 TB/s.
//
// Design: one warp per row, eight rows a CTA, no shared memory and no block
// barrier, so the width is not capped. The warp keeps the best keys of the
// row seen so far as a sorted list: entry p lives in lane p % 32 of register
// slot p / 32 (one slot for k <= 32, two for k <= 64); empty entries hold the
// sentinel (-inf, INT_MAX). Columns go into the list one at a time, lowest
// column first: a ballot over the list gives the place, a __shfl_up moves
// the entries behind it down one (the last drops out), and the k-th value is
// read again. Every column in the list is lower than the one going in, so a
// list entry stays ahead of it when its value is not smaller, and a column
// beats the k-th entry only when its value is strictly larger: equal values
// keep the lower column without comparing columns.
//
// The head of the row, its first TOPK_ROWS_HEAD steps of 32 columns, is
// loaded at once into registers. For k <= 32 the k-th largest of the 32 lane
// maxima over the head is a floor: those maxima are 32 distinct entries of
// the row, so no entry below it is among the row's k best. Head columns at
// or above the floor go in while the list holds fewer than k, later only
// when they beat the k-th. The rest of the row streams through in coalesced
// steps of 32 columns, TOPK_ROWS_STEPS steps a batch, the next batch's loads
// issued before the current one is processed; a step's lanes that beat the
// k-th raise their bit in a ballot and go in lowest lane first, the ballot
// taken again after each. A random row inserts ~k (1 + ln(w / 640)) times
// (~60 at w = 3136, k = 20; ~25 at w = 640); a merge row, whose first k
// columns are the best so far, fewer; an ascending row at every column:
// slow, and still exact.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

#include "warp_list.cuh"

#ifndef TOPK_ROWS_HEAD
#define TOPK_ROWS_HEAD 20
#endif
#ifndef TOPK_ROWS_STEPS
#define TOPK_ROWS_STEPS 8
#endif

namespace {

using namespace warp_list;

constexpr int kWarps = 8;                 // rows a CTA
constexpr int kHead = TOPK_ROWS_HEAD;     // 32-column steps of the head block
constexpr int kSteps = TOPK_ROWS_STEPS;   // 32-column steps a streamed batch
static_assert(kHead >= 2, "the head must hold 64 columns, so that k <= 64 fill the list");

// The k-th largest of one value a lane (k <= 32), in every lane: a bitonic
// sort of the values, descending from lane 0.
__device__ __forceinline__ float warp_kth_largest(float m, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kFull, m, stride);
      // a descending block's lower lane keeps the larger value of the pair
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      m = keep_max ? fmaxf(m, o) : fminf(m, o);
    }
  }
  return __shfl_sync(kFull, m, k - 1);
}

// Inserts (v, col), whose column is above every column in the list, at its
// place in the list. The list's first `filled` entries hold columns; the
// rest hold the sentinel, which goes behind any column, also an -inf one.
template <int S>
__device__ __forceinline__ void insert(float (&ev)[S], int (&ec)[S], float v, int col,
                                       int filled, int lane) {
  insert_at<S>(ev, ec, v, col, min(place_after_ties<S>(ev, v), filled), lane);
}

// One step of 32 head columns, col0 + lane holding xv. A column goes in when
// it lies in the row, is not below `floor_v`, and the list holds fewer than
// k columns or it beats the k-th.
template <int S>
__device__ __forceinline__ void head_step(float (&ev)[S], int (&ec)[S], float& thr, int& filled,
                                          float xv, unsigned col0, unsigned w, float floor_v,
                                          int k, int lane) {
  const bool fit = col0 + lane < w && xv >= floor_v;
  unsigned m = __ballot_sync(kFull, fit && (filled < k || xv > thr));
  while (m) {
    const int src = __ffs(m) - 1;
    insert<S>(ev, ec, __shfl_sync(kFull, xv, src), static_cast<int>(col0) + src, filled, lane);
    ++filled;
    thr = kth_value<S>(ev, k);
    m = __ballot_sync(kFull, lane > src && fit && (filled < k || xv > thr));
  }
}

// One streamed step of 32 columns (-inf past the row's end), the list full.
template <int S>
__device__ __forceinline__ void step(float (&ev)[S], int (&ec)[S], float& thr, float xv,
                                     unsigned col0, int k, int lane) {
  unsigned m = __ballot_sync(kFull, xv > thr);
  while (m) {
    const int src = __ffs(m) - 1;
    insert<S>(ev, ec, __shfl_sync(kFull, xv, src), static_cast<int>(col0) + src, 32 * S,
              lane);
    thr = kth_value<S>(ev, k);
    m = __ballot_sync(kFull, lane > src && xv > thr);
  }
}

template <int N>
__device__ __forceinline__ void load_steps(const float* __restrict__ xr, unsigned w,
                                           unsigned base, int lane, float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const unsigned c = base + 32u * j + lane;
    v[j] = c < w ? __ldg(xr + c) : -INFINITY;
  }
}

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ idx, int n, int w, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;                   // the whole warp: no barrier follows
  const float* xr = x + static_cast<size_t>(row) * w;
  const unsigned uw = static_cast<unsigned>(w);
  constexpr unsigned kHeadCols = 32u * kHead;

  float head[kHead], cur[kSteps], nxt[kSteps];
  load_steps(xr, uw, 0u, lane, head);
  load_steps(xr, uw, kHeadCols, lane, cur);

  // The head's 32 lane maxima are 32 distinct entries of the row, so their
  // k-th largest is no larger than the row's k-th: no column below it can
  // be among the k best.
  float floor_v = -INFINITY;
  if constexpr (S == 1) {
    float m = head[0];
#pragma unroll
    for (int j = 1; j < kHead; ++j) m = fmaxf(m, head[j]);
    floor_v = warp_kth_largest(m, k, lane);
  }
  float ev[S];
  int ec[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    ev[s] = -INFINITY;
    ec[s] = INT_MAX;
  }
  float thr = -INFINITY;
  int filled = 0;
#pragma unroll
  for (int j = 0; j < kHead; ++j)
    head_step<S>(ev, ec, thr, filled, head[j], 32u * j, uw, floor_v, k, lane);

  // at least k head columns reach the floor, so the list is full from here
  for (unsigned base = kHeadCols; base < uw; base += 32u * kSteps) {
    load_steps(xr, uw, base + 32u * kSteps, lane, nxt);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) step<S>(ev, ec, thr, cur[j], base + 32u * j, k, lane);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) cur[j] = nxt[j];
  }

  float* vr = vals + static_cast<size_t>(row) * k;
  int* ir = idx + static_cast<size_t>(row) * k;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int p = 32 * s + lane;
    if (p < k) {
      vr[p] = ev[s];
      ir[p] = ec[s];
    }
  }
}

}  // namespace

// Launch on `stream`: x (n, w) fp32 row-major -> vals (n, k) fp32 and
// idx (n, k) int32. Requires 1 <= k <= min(64, w). Returns cudaGetLastError().
extern "C" int topk_rows_launch(const float* x, float* vals, int* idx, int n, int w, int k,
                                void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32)
    topk_rows_kernel<1><<<blocks, kWarps * 32, 0, s>>>(x, vals, idx, n, w, k);
  else
    topk_rows_kernel<2><<<blocks, kWarps * 32, 0, s>>>(x, vals, idx, n, w, k);
  return static_cast<int>(cudaGetLastError());
}
