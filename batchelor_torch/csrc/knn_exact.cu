// Exact k-nearest-neighbour search in one pass, for Hopper (sm_90a): K5.
//
// Replaces, on the card, the tile loop of batchelor_torch/ops/knn.py's
// _knn_tiled (an fp32 product, four elementwise passes, a concatenation and
// K2 for every 16,384 x 8,192 block of scores) with one kernel that keeps
// each score in registers and the running top-k of each query in shared
// memory. No score reaches device memory.
//
// Contract: for each of nq query rows (fp32, row-major, width d <= 128),
// the k <= 64 best of nd data rows by the score
//     (2 q.x - |x|^2) - |q|^2,
// rounded in that order as _knn_tiled rounds it, q.x an fp32 FMA chain over
// the width. The norms come from the caller (the same torch reductions as
// _knn_tiled's), the data rows' padded with +inf to a multiple of 128; a
// data row whose norm is +inf (masked) scores -inf and never enters.
// Order: score descending, ties to the lower data row, so the result is the
// top k under (score desc, row asc). Out: int64 rows and squared distances
// max(-score, 0); a query with fewer than k finite scores gets (row 0,
// +inf) in the rest, as _knn_tiled does.
//
// Bound on this card: fp32 FMAs, d of them a score, at 67 TFLOP/s. No TF32,
// no bf16, no split products.
//
// Design: one CTA of 256 threads per 128 query rows (and per range of data
// tiles, grid.y, when the queries alone fill the card too thinly). The
// query tile is copied once, transposed, into shared memory. Data tiles of
// 128 rows arrive whole, row-major as they lie in device memory, by one 1-D
// bulk copy (TMA) each with their norms, into a ring of one or two stages
// (two where shared memory allows) whose `full` mbarriers the warps wait
// on; rows whose stride in shared memory would put the lanes of a warp on
// one bank (d a multiple of 32) come row by row with a padded stride
// instead. Each thread holds an 8 x 8 block of scores: query rows
// warp*16 + half*4 + {0..3, 8..11}, data rows lx + 16 j (j < 8), so the 16
// lanes of a half-warp read 16 rows of the tile at once, two widths at a
// time where the layout aligns them. A warp owns its 16 query rows, so the
// selection needs no block barrier: after a tile each thread compares its
// scores with its rows' current k-th, and where any lane of the warp holds
// a survivor the warp streams the row's scores against its sorted list
// (merge_rows, the insertion of K2 in warp_list.cuh). The last warp to
// finish with a stage (a counter in shared memory) issues the copy of the
// tile two ahead into it, so a warp that spends long on its selection
// holds the others back by no more than a tile.
//
// With grid.y > 1 each CTA writes its range's list (fp32 scores, int32
// rows) to scratch and knn_exact_merge_kernel, one warp a query, merges the
// ranges' lists under the order (score desc, row asc).

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "tma_wgmma.cuh"
#include "warp_list.cuh"

namespace {

using namespace warp_list;
using tma_wgmma::bulk_load_if;
using tma_wgmma::fence_barrier_init;
using tma_wgmma::mbar_expect_tx_if;
using tma_wgmma::mbar_init;
using tma_wgmma::mbar_wait;
using tma_wgmma::smem_u32;

constexpr int kRows = 128;                // query rows a CTA
constexpr int kCols = 128;                // data rows a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLd = kRows + 4;            // floats between two widths of the query tile
constexpr int kMaxD = 128;
constexpr int kMaxStages = 2;
constexpr int kHeader = 64;               // bytes: the full mbarriers, the stages' counters
constexpr size_t kMaxSmem = 232448;       // a block's shared memory on sm_90
constexpr int kUnroll = 4;                // width steps of the products' loop body
constexpr int kMinBlocks = 2;             // resident CTAs an SM that registers must allow

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// Shared-memory layout for width d, k and `stages`, in floats after the
// header: the query tile (d4 x kLd, transposed), its norms (kRows), the
// stages (a tile of kCols rows of row_ld floats, 4 floats of slack for an
// unaligned start, then its kCols norms), the warps' score rows (kWarps x 2
// x kCols) and the lists (kRows x k values, then kRows x k rows).
struct Layout {
  int d4, row_ld, tile_floats, stage_floats, stages;
  __host__ __device__ Layout(int d, int stages_)
      : d4((d + 3) & ~3), row_ld(d % 32 == 0 ? d + 4 : d),
        tile_floats((kCols * row_ld + 4 + 3) & ~3), stage_floats(tile_floats + kCols),
        stages(stages_) {}
  __host__ __device__ size_t bytes(int k) const {
    return kHeader + sizeof(float) * (static_cast<size_t>(d4) * kLd + kRows +
                                      static_cast<size_t>(stages) * stage_floats +
                                      kWarps * 2 * kCols + 2 * static_cast<size_t>(kRows) * k);
  }
};

// Two stages where they fit in a block's shared memory, else one.
int stages_for(int d, int k) { return Layout(d, 2).bytes(k) <= kMaxSmem ? 2 : 1; }

// One width step: acc[i][j] += q[row i][w] x[col j][w].
__device__ __forceinline__ void fma_width(float (&acc)[8][8], const float* qw, const float* xw,
                                          int col_step) {
  const float4 a0 = *reinterpret_cast<const float4*>(qw);
  const float4 a1 = *reinterpret_cast<const float4*>(qw + 8);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float b = xw[j * col_step];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
  }
}

// Two width steps, w then w + 1, the data read as float pairs.
__device__ __forceinline__ void fma_width_pair(float (&acc)[8][8], const float* qw,
                                               const float* xw, int col_step) {
  const float4 a0 = *reinterpret_cast<const float4*>(qw);
  const float4 a1 = *reinterpret_cast<const float4*>(qw + 8);
  const float4 a2 = *reinterpret_cast<const float4*>(qw + kLd);
  const float4 a3 = *reinterpret_cast<const float4*>(qw + kLd + 8);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float c[8] = {a2.x, a2.y, a2.z, a2.w, a3.x, a3.y, a3.z, a3.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(xw + j * col_step);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(c[i], b.y, fmaf(a[i], b.x, acc[i][j]));
  }
}

// The warp's selection for one row slot of its threads: `rows` holds the
// tile's scores of the half-warps' two query rows (row0 and row0 + 4),
// kCols each in column order; `halves` has a bit in each half-warp whose
// row has a survivor. Each such row streams through in steps of 32 columns
// against its sorted list, K2's way: the columns go in ascending, every
// list entry holds a lower row, so a score enters only when it beats the
// k-th strictly and goes behind equal values.
template <int S>
__device__ __forceinline__ void merge_rows(const float* rows, unsigned halves, int row0, int base,
                                           float* list_v, int* list_i, int k, int lane) {
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (!(halves & (h ? 0xffff0000u : 0x0000ffffu))) continue;
    float* lv = list_v + (row0 + 4 * h) * k;
    int* li = list_i + (row0 + 4 * h) * k;
    float ev[S];
    int ec[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int p = 32 * s + lane;
      ev[s] = p < k ? lv[p] : -INFINITY;
      ec[s] = p < k ? li[p] : INT_MAX;
    }
    float thr = kth_value<S>(ev, k);
#pragma unroll 1
    for (int c0 = 0; c0 < kCols; c0 += 32) {
      const float v = rows[h * kCols + c0 + lane];
      unsigned m = __ballot_sync(kFull, v > thr);
      while (m) {
        const int src = __ffs(m) - 1;
        const float sv = __shfl_sync(kFull, v, src);
        insert_at<S>(ev, ec, sv, base + c0 + src, place_after_ties<S>(ev, sv), lane);
        thr = kth_value<S>(ev, k);
        m = __ballot_sync(kFull, lane > src && v > thr);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int p = 32 * s + lane;
      if (p < k) {
        lv[p] = ev[s];
        li[p] = ec[s];
      }
    }
  }
}

template <int S, bool kPairs>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
knn_exact_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 const float* __restrict__ qn, const float* __restrict__ dn, int nq, int nd,
                 int d, int k, int tiles_per_range, int stages, int64_t* __restrict__ out_idx,
                 float* __restrict__ out_dist, float* __restrict__ part_s,
                 int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* done = reinterpret_cast<int*>(smem + kMaxStages * sizeof(uint64_t));
  float* q_s = reinterpret_cast<float*>(smem + kHeader);
  float* qn_s = q_s + L.d4 * kLd;
  float* ring = qn_s + kRows;
  float* scratch = ring + stages * L.stage_floats;
  float* list_v = scratch + kWarps * 2 * kCols;
  int* list_i = reinterpret_cast<int*>(list_v + kRows * k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane >> 4, lx = lane & 15;
  const int q0 = blockIdx.x * kRows;
  const int n_tiles = (nd + kCols - 1) / kCols;
  const int t_begin = blockIdx.y * tiles_per_range;
  const int n_here = max(min(t_begin + tiles_per_range, n_tiles) - t_begin, 0);
  const bool by_row = L.row_ld != d;
  // floats by which x starts past a 16-byte boundary; a whole tile is a
  // multiple of 4 floats, so every tile starts the same way
  const int x_off = by_row ? 0 : static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);

  // The query tile, transposed; consecutive threads read along a row.
  for (int e = tid; e < kRows * L.d4; e += kThreads) {
    const int r = e / L.d4, w = e - r * L.d4;
    const bool ok = q0 + r < nq && w < d;
    cp_async4(q_s + w * kLd + r, ok ? q + static_cast<size_t>(q0 + r) * d + w : q, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (tid < kRows) qn_s[tid] = q0 + tid < nq ? qn[q0 + tid] : 0.0f;
  for (int e = tid; e < kRows * k; e += kThreads) {
    list_v[e] = -INFINITY;
    list_i[e] = 0;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    fence_barrier_init();
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // Tile j of the range into stage j % stages, by the lanes of one warp:
  // the rows as one bulk copy (with up to 3 floats at each end copied by
  // hand where x is not 16-byte aligned), or one copy a row in the padded
  // layout; the norms as one bulk copy. Lane 0 arms the stage's barrier
  // after the hand copies, which its arrival releases.
  auto issue = [&](int j) {
    const int s = stages == 1 ? 0 : j & 1;
    float* st = ring + s * L.stage_floats;
    const int row0 = (t_begin + j) * kCols;
    const int rows = min(kCols, nd - row0);
    const float* src = x + static_cast<size_t>(row0) * d;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (by_row) {
      mbar_expect_tx_if(&full[s], (rows * d + kCols) * 4, lane == 0);
      __syncwarp();
      for (int r = lane; r < rows; r += 32)
        bulk_load_if(smem_u32(st + r * L.row_ld), src + static_cast<size_t>(r) * d, d * 4,
                     &full[s], true);
    } else {
      float* xs = st + x_off;
      const int total = rows * d;
      const int head = min((4 - x_off) & 3, total);
      const int mid = (total - head) & ~3;
      if (lane < head) xs[lane] = src[lane];
      if (lane < total - head - mid) xs[head + mid + lane] = src[head + mid + lane];
      __syncwarp();
      mbar_expect_tx_if(&full[s], (mid + kCols) * 4, lane == 0);
      bulk_load_if(smem_u32(xs + head), src + head, mid * 4, &full[s], lane == 0 && mid > 0);
    }
    bulk_load_if(smem_u32(st + L.tile_floats), dn + row0, kCols * 4, &full[s], lane == 0);
  };
  if (warp == 0)
    for (int j = 0; j < min(stages, n_here); ++j) issue(j);

  const int qoff = warp * 16 + half * 4;  // rows qoff + {0..3} and qoff + 8 + {0..3}
  float acc[8][8];
  for (int j = 0; j < n_here; ++j) {
    const int s = stages == 1 ? 0 : j & 1;
    const float* st = ring + s * L.stage_floats;
    const float* xs = st + x_off + lx * L.row_ld;
    const int col_step = 16 * L.row_ld;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
    mbar_wait(&full[s], (stages == 1 ? j : j >> 1) & 1);
    if constexpr (kPairs) {
#pragma unroll kUnroll
      for (int w = 0; w < d; w += 2) fma_width_pair(acc, q_s + w * kLd + qoff, xs + w, col_step);
    } else {
#pragma unroll kUnroll
      for (int w = 0; w < d; ++w) fma_width(acc, q_s + w * kLd + qoff, xs + w, col_step);
    }

    // Scores of the tile, then the warp's selection.
    const int base = (t_begin + j) * kCols;
    float dv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) dv[c] = st[L.tile_floats + lx + 16 * c];
    const float4 m0 = *reinterpret_cast<const float4*>(qn_s + qoff);
    const float4 m1 = *reinterpret_cast<const float4*>(qn_s + qoff + 8);
    const float qv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
    bool any = false;
    bool row_any[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float kth = list_v[(qoff + (i & 3) + (i >> 2) * 8) * k + k - 1];
      float best = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[i][c] = fmaf(2.0f, acc[i][c], -dv[c]) - qv[i];
        best = fmaxf(best, acc[i][c]);
      }
      row_any[i] = best > kth;
      any |= row_any[i];
    }

    // The stage is read: the last warp done with it refills it.
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&done[s], 1) == kWarps - 1;
    }
    if (__shfl_sync(kFull, last, 0)) {
      __threadfence_block();
      if (lane == 0) done[s] = 0;
      if (j + stages < n_here) issue(j + stages);
    }

    if (__any_sync(kFull, any)) {
      float* rows = scratch + warp * 2 * kCols;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned halves = __ballot_sync(kFull, row_any[i]);
        if (!halves) continue;
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 8; ++c) rows[half * kCols + lx + 16 * c] = acc[i][c];
        __syncwarp();
        merge_rows<S>(rows, halves, warp * 16 + (i & 3) + (i >> 2) * 8, base, list_v, list_i, k,
                      lane);
      }
      __syncwarp();
    }
  }
  __syncwarp();

  // The warp's 16 rows, each a run of k entries.
  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr, g = q0 + row;
    if (g >= nq) break;
    for (int p = lane; p < k; p += 32) {
      const float v = list_v[row * k + p];
      const int col = list_i[row * k + p];
      if (part_s == nullptr) {
        out_idx[static_cast<size_t>(g) * k + p] = col;
        out_dist[static_cast<size_t>(g) * k + p] = fmaxf(-v, 0.0f);
      } else {
        const size_t o = (static_cast<size_t>(blockIdx.y) * nq + g) * k + p;
        part_s[o] = v;
        part_i[o] = col;
      }
    }
  }
}

// One warp a query: the ranges' lists, in the order (score desc, row asc).
template <int S>
__global__ void __launch_bounds__(256)
knn_exact_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                       int ranges, int nq, int k, int64_t* __restrict__ out_idx,
                       float* __restrict__ out_dist) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (g >= nq) return;                    // the whole warp: no barrier follows
  float ev[S];
  int ec[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int p = 32 * s + lane;
    ev[s] = -INFINITY;
    ec[s] = p < k ? 0 : INT_MAX;
  }
  float tv = -INFINITY;
  int tc = 0;
  for (int r = 0; r < ranges; ++r) {
    const size_t o = (static_cast<size_t>(r) * nq + g) * k;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int p = 32 * s + lane;
      const float v = p < k ? part_s[o + p] : -INFINITY;
      const int col = p < k ? part_i[o + p] : INT_MAX;
      unsigned m = __ballot_sync(kFull, beats(v, col, tv, tc));
      while (m) {
        const int src = __ffs(m) - 1;
        const float sv = __shfl_sync(kFull, v, src);
        const int sc = __shfl_sync(kFull, col, src);
        insert_at<S>(ev, ec, sv, sc, place_ordered<S>(ev, ec, sv, sc), lane);
        tv = kth_value<S>(ev, k);
        tc = kth_column<S>(ec, k);
        m = __ballot_sync(kFull, lane > src && beats(v, col, tv, tc));
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int p = 32 * s + lane;
    if (p < k) {
      out_idx[static_cast<size_t>(g) * k + p] = ec[s];
      out_dist[static_cast<size_t>(g) * k + p] = fmaxf(-ev[s], 0.0f);
    }
  }
}

// The search kernel for k and whether the layout reads float pairs.
using KernelFn = void (*)(const float*, const float*, const float*, const float*, int, int, int,
                          int, int, int, int64_t*, float*, float*, int*);
KernelFn kernel_for(int k, bool pairs) {
  if (k <= 32) return pairs ? knn_exact_kernel<1, true> : knn_exact_kernel<1, false>;
  return pairs ? knn_exact_kernel<2, true> : knn_exact_kernel<2, false>;
}

// Float pairs need even widths and pairs that start 8-byte aligned in the
// stage: the padded layout's rows start 16-byte aligned, the flat layout's
// where x's address does.
bool reads_pairs(int d, uintptr_t x_address) {
  return d % 2 == 0 && (d % 32 == 0 || (x_address & 7) == 0);
}

}  // namespace

// CTAs of the search kernel that the card holds at once for width d, k and
// data whose address modulo 16 is x_mod16 (its alignment picks the kernel):
// SMs x resident CTAs an SM. Also lifts the shared-memory limit of every
// instantiation to a block's maximum on the current device, which
// knn_exact_launch relies on: call it once per device before launching
// there. Returns a cudaError_t.
extern "C" int knn_exact_slots(int d, int k, int x_mod16, int* slots) {
  if (d < 1 || d > kMaxD || k < 1 || k > 64) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn all[] = {knn_exact_kernel<1, false>, knn_exact_kernel<1, true>,
                          knn_exact_kernel<2, false>, knn_exact_kernel<2, true>};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  for (const KernelFn fn : all)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_for(k, reads_pairs(d, static_cast<uintptr_t>(x_mod16))), kThreads,
        Layout(d, stages_for(d, k)).bytes(k));
  if (e != cudaSuccess) return static_cast<int>(e);
  *slots = sms * per_sm;
  return 0;
}

// Launch on `stream`. q (nq, d) and x (nd, d) fp32 row-major (x 16-byte
// aligned where d is a multiple of 32), qn (nq) their squared norms and dn
// the data rows' (+inf for excluded rows), padded with +inf to a multiple
// of 128 and 16-byte aligned; out_idx (nq, k) int64, out_dist (nq, k)
// fp32. With ranges > 1, the data tiles are split into ranges of
// tiles_per_range tiles (ranges = ceil(tiles / tiles_per_range)), and
// part_s (ranges, nq, k) fp32 and part_i (ranges, nq, k) int32 hold the
// ranges' lists between the two kernels. Requires 1 <= d <= 128,
// 1 <= k <= 64, nd >= 1, and knn_exact_slots called on this device.
// Returns cudaGetLastError().
extern "C" int knn_exact_launch(const float* q, const float* x, const float* qn, const float* dn,
                                int nq, int nd, int d, int k, int ranges, int tiles_per_range,
                                float* part_s, int* part_i, int64_t* out_idx, float* out_dist,
                                void* stream) {
  if (nq == 0) return 0;
  if (d < 1 || d > kMaxD || k < 1 || k > 64 || nd < 1 || ranges < 1 || tiles_per_range < 1 ||
      (reinterpret_cast<uintptr_t>(dn) & 15) || (d % 32 == 0 && (reinterpret_cast<uintptr_t>(x) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int stages = stages_for(d, k);
  const size_t smem = Layout(d, stages).bytes(k);
  const KernelFn fn = kernel_for(k, reads_pairs(d, reinterpret_cast<uintptr_t>(x)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + kRows - 1) / kRows, ranges);
  float* ps = ranges > 1 ? part_s : nullptr;
  int* pi = ranges > 1 ? part_i : nullptr;
  fn<<<grid, kThreads, smem, s>>>(q, x, qn, dn, nq, nd, d, k, tiles_per_range, stages, out_idx,
                                  out_dist, ps, pi);
  if (ranges > 1) {
    const int blocks = (nq + 7) / 8;
    if (k <= 32)
      knn_exact_merge_kernel<1><<<blocks, 256, 0, s>>>(ps, pi, ranges, nq, k, out_idx, out_dist);
    else
      knn_exact_merge_kernel<2><<<blocks, 256, 0, s>>>(ps, pi, ranges, nq, k, out_idx, out_dist);
  }
  return static_cast<int>(cudaGetLastError());
}
