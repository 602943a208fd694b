// Rescore of the two-pass kNN's selected sub-chunks, for Hopper (sm_90a).
//
// Replaces: benchmarks/knn_dma_rescore_probe.py, _gather_kernel (called
// through dma_gather). The TPU kernel copies each query's selected (32, d)
// sub-chunks into a contiguous buffer in device memory, which XLA then
// rescores. This kernel fuses the gather with the product that consumes it.
//
// Contract: q (nq, d), data3 (c32, 32, d), dn2 (c32, 32) fp32, top_sub
// (nq, ks) int64 with ids in [0, c32); it writes
//     out[i, j * 32 + r] = 2 * q[i] . data3[top_sub[i, j], r] - dn2[top_sub[i, j], r]
// with fp32 sums, out (nq, ks * 32). The gathered blocks never reach device
// memory. (An id outside [0, c32) gets a row of NaN instead of a fault.)
//
// Bound on this card: at the main path's shape (nq = 100,000, ks = 20,
// d = 50) 6.4e9 fp32 flop, 0.096 ms at 67 TFLOP/s, against ~0.3 GB of
// unique bytes (0.09 ms at 3.35 TB/s), most of it the 256 MB score write.
// A kernel that reads each selected block once per query that chose it
// reads 12.8 GB (from the 50 MB L2 while data3 fits there, from device
// memory when it does not) and is bound by that, not by either figure.
//
// Design: sub-chunk stationary. Call a (query i, rank j) pair a slot,
// s = i * ks + j; out is (nq * ks, 32), one 128-byte row per slot. Where
// the slots are fewer than RESCORE_SORT_MIN a sub-chunk on average (a few
// queries against many sub-chunks), few blocks are chosen often enough for
// the sort to pay for itself: by_query_kernel (one warp a query, each
// selected block staged for its query) runs instead, chosen from the
// shapes (rescore_subchunks_sorts).
//  1. bucket_count_kernel: counts the slots of each sub-chunk. A CTA takes
//     8,192 slots; up to 8,192 sub-chunks it counts them in shared memory,
//     each slot keeping the count it saw, and then adds each nonzero count
//     to the global one by one atomic whose result is the CTA's base in
//     that bucket; a slot's rank in its bucket is base + its count. (Above
//     8,192 sub-chunks every slot takes a global atomic.) The CTA that
//     finishes last scans the counts into offsets.
//  2. bucket_scatter_kernel: slot s goes to offsets[c] + rank[s] as the
//     pair (s, c), so the slots lie sorted by sub-chunk.
//  3. rescore_kernel: CTA t takes sorted slots [t * P, t * P + P). A run of
//     equal sub-chunks in it is a segment; for each segment the CTA stages
//     data3[c] and the segment's query rows in shared memory once, both
//     feature-major, with cp.async (every copy of a stage in flight at
//     once), and its 2P threads compute the (queries x 32) product, each
//     thread 4 queries x 4 rows, every sum one fixed-order fmaf chain over
//     the features. A bucket of 33,000 slots is cut into P-slot items that
//     run side by side, and runs of small buckets share an item; warps
//     whose queries lie past a small segment's end skip it. Features are
//     staged KT at a time, so any d fits; shared memory is sized to d.
// What holds step 3 back on this card (tools/k3_ab.py, PERF.md): staging
// alone and the products alone each take ~0.24 ms at the main path's shape.
// The products are bound by shared memory: a warp's 16-byte load takes 4 of
// the SM's 1-a-clock wavefronts, so 8 floats a thread a feature against its
// 16 FMAs cap them at half the fp32 rate. The staging gathers query rows
// with 4-byte copies (rows are 4-byte aligned for any d). A CTA stages and
// then multiplies, so the overlap of the two comes from the 8 CTAs an SM
// (64 registers); 8 x 4 tiles (112 registers) and a double-buffered CTA
// that walks 1,024 sorted slots (96 registers) each lowered that and were
// no faster.
// The grid of every step follows from the shapes: nothing is read back to
// the host. Each output is one fmaf chain in feature order whatever order
// the atomics gave the slots, so the result is deterministic.
// Shared-memory layout: feature k's row holds 4-float groups g (rows 4g..
// 4g+3 of the sub-chunk, or queries 4g..4g+3 of the segment) at group
// g ^ (k & 7). The compute's 16-byte reads of one feature stay contiguous
// groups, and the staging's copies (a warp: 4 rows x 8 features) fall in
// 32 different banks.

#include <cuda_runtime.h>

#ifndef RESCORE_SLOTS
#define RESCORE_SLOTS 64      // P: sorted slots per work item
#endif
#ifndef RESCORE_SORT_MIN
#define RESCORE_SORT_MIN 2.0  // sort the slots when they are this many a sub-chunk
#endif
#ifndef RESCORE_MIN_BLOCKS
#define RESCORE_MIN_BLOCKS (1024 / (2 * RESCORE_SLOTS))   // CTAs an SM the registers allow
#endif

namespace {

constexpr int SUB = 32;                 // data rows per sub-chunk
constexpr int P = RESCORE_SLOTS;
constexpr int KT = 64;                  // features staged at most, a multiple of 8
constexpr int THREADS = 2 * P;          // P / 4 query groups x 8 row groups
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = RESCORE_MIN_BLOCKS;
constexpr int QUERY_WARPS = 4;          // queries a CTA of the query-stationary kernel
constexpr int QUERY_PIECE = 2048;       // floats of a sub-chunk it stages at once
constexpr int SMEM_MAX = 227 * 1024;    // shared memory a CTA can use
constexpr int COUNT_THREADS = 1024;
constexpr int COUNT_ITEMS = 8;          // slots a thread counts
constexpr int COUNT_SLOTS = COUNT_THREADS * COUNT_ITEMS;
constexpr int HIST_MAX = COUNT_SLOTS;   // sub-chunks counted in shared memory
// the swizzle takes 8 groups of 4 queries: P >= 32
static_assert(P % 32 == 0 && P <= 128, "P: 32, 64, 96 or 128");

// Exclusive scan of counts[0, n) into offsets[0, n], offsets[n] the total,
// by one CTA of COUNT_THREADS threads in tiles of COUNT_SLOTS counts.
__device__ void scan_counts(const int* counts, int* offsets, int n, int* tile) {
  __shared__ int warp_sums[COUNT_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += COUNT_SLOTS) {
#pragma unroll
    for (int u = 0; u < COUNT_ITEMS; ++u) {       // coalesced, from L2 (atomics' results)
      const int e = base + u * COUNT_THREADS + tid;
      tile[u * COUNT_THREADS + tid] = e < n ? __ldcg(counts + e) : 0;
    }
    __syncthreads();
    int v[COUNT_ITEMS], sum = 0;
#pragma unroll
    for (int u = 0; u < COUNT_ITEMS; ++u) {
      v[u] = tile[tid * COUNT_ITEMS + u];
      sum += v[u];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < COUNT_THREADS / 32; ++w) {
      const int ws = warp_sums[w];
      before += w < warp ? ws : 0;
      total += ws;
    }
    int run = carry + before + incl - sum;
#pragma unroll
    for (int u = 0; u < COUNT_ITEMS; ++u) {
      tile[tid * COUNT_ITEMS + u] = run;
      run += v[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < COUNT_ITEMS; ++u) {
      const int e = base + u * COUNT_THREADS + tid;
      if (e < n) offsets[e] = tile[u * COUNT_THREADS + tid];
    }
    carry += total;
    __syncthreads();                              // tile and warp_sums are reused
  }
  if (tid == 0) offsets[n] = carry;
}

// One CTA a COUNT_SLOTS slots. counts[0, c32) must be 0, and counts[c32]
// (the CTAs' finishing ticket) too.
__global__ void __launch_bounds__(COUNT_THREADS)
bucket_count_kernel(const long long* __restrict__ top_sub, int* __restrict__ counts,
                    int* __restrict__ rank, int* __restrict__ offsets, int n_slots, int c32) {
  __shared__ int hist[HIST_MAX];                  // the local counts, then the scan's tile
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * COUNT_SLOTS + tid;
  int cc[COUNT_ITEMS], r[COUNT_ITEMS];
#pragma unroll
  for (int u = 0; u < COUNT_ITEMS; ++u) {
    const int s = s0 + u * COUNT_THREADS;
    const long long c = s < n_slots ? top_sub[s] : -1;
    cc[u] = c >= 0 && c < c32 ? static_cast<int>(c) : -1;
  }
  if (c32 <= HIST_MAX) {
    for (int c = tid; c < c32; c += COUNT_THREADS) hist[c] = 0;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < COUNT_ITEMS; ++u) r[u] = cc[u] >= 0 ? atomicAdd(hist + cc[u], 1) : -1;
    __syncthreads();
    for (int c = tid; c < c32; c += COUNT_THREADS) {
      const int h = hist[c];
      if (h) hist[c] = atomicAdd(counts + c, h);  // this CTA's base in bucket c
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < COUNT_ITEMS; ++u) r[u] += cc[u] >= 0 ? hist[cc[u]] : 0;
  } else {
#pragma unroll
    for (int u = 0; u < COUNT_ITEMS; ++u) r[u] = cc[u] >= 0 ? atomicAdd(counts + cc[u], 1) : -1;
  }
#pragma unroll
  for (int u = 0; u < COUNT_ITEMS; ++u) {
    const int s = s0 + u * COUNT_THREADS;
    if (s < n_slots) rank[s] = r[u];
  }
  __threadfence();                                // this CTA's counts before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(counts + c32, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  scan_counts(counts, offsets, c32, hist);
}

__global__ void bucket_scatter_kernel(const long long* __restrict__ top_sub,
                                      const int* __restrict__ rank,
                                      const int* __restrict__ offsets, int2* __restrict__ sorted,
                                      float* __restrict__ out, int n_slots) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const int r = rank[s];
  if (r >= 0) {
    const int c = static_cast<int>(top_sub[s]);
    sorted[offsets[c] + r] = make_int2(s, c);
  } else {                                        // an id outside [0, c32)
    for (int e = 0; e < SUB; ++e) out[static_cast<size_t>(s) * SUB + e] = __int_as_float(0x7fffffff);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// 4-byte asynchronous copy to shared memory; `fill` false writes 0 and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(fill ? 4 : 0)
               : "memory");
}

// The first segment start after position p (the bits of `starts`), or n.
__device__ __forceinline__ int next_start(const unsigned* starts, int p, int n) {
  for (int w = p >> 5; w < P / 32; ++w) {
    const unsigned m = starts[w] & (w == (p >> 5) ? ~0u << (p & 31) : ~0u);
    if (m) return min(n, w * 32 + __ffs(m) - 1);
  }
  return n;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rescore_kernel(const float* __restrict__ q, const float* __restrict__ data3,
               const float* __restrict__ dn2, const int2* __restrict__ sorted,
               const int* __restrict__ offsets, float* __restrict__ out, int ks, int d,
               int c32, int kcap) {
  // data3[c] (kcap x 32) and the segment's query rows (kcap x P), both
  // feature-major and swizzled; kcap = d rounded up to 8, at most KT
  extern __shared__ __align__(16) float xs[];
  float* qs = xs + kcap * SUB;
  __shared__ int slot_s[P], qrow_s[P], c_s[P];
  __shared__ unsigned starts[P / 32];
  const int n_valid = offsets[c32];               // slots with an id in range
  const int a = blockIdx.x * P;
  if (a >= n_valid) return;
  const int n = min(P, n_valid - a);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int p = tid; p < P; p += THREADS) {
    int slot = 0, c = -1;
    if (p < n) {
      const int2 e = sorted[a + p];
      slot = e.x;
      c = e.y;
    }
    slot_s[p] = slot;
    qrow_s[p] = slot / ks;
    c_s[p] = c;
  }
  __syncthreads();
  for (int p = tid; p < P; p += THREADS) {        // whole warps: P is a multiple of 32
    const bool start = p < n && (p == 0 || c_s[p] != c_s[p - 1]);
    const unsigned m = __ballot_sync(0xffffffffu, start);
    if (lane == 0) starts[p >> 5] = m;
  }
  __syncthreads();

  // compute roles: warp w owns the segment's queries [16w, 16w + 16)
  const int tr = lane & 7;                        // rows 4tr .. 4tr + 3
  const int tq = warp * 4 + (lane >> 3);          // queries 4tq .. 4tq + 3
  // staging roles: a warp moves 4 rows (or queries) x 8 features at once
  const int sb = tid & 3, skl = (tid >> 2) & 7;

  for (int s0 = 0; s0 < n;) {
    const int s1 = next_start(starts, s0 + 1, n);
    const int ns = s1 - s0, c = c_s[s0];
    const bool active = 16 * warp < ns;
    const float* xb = data3 + static_cast<size_t>(c) * SUB * d;
    float4 dn = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) dn = *reinterpret_cast<const float4*>(dn2 + static_cast<size_t>(c) * SUB + 4 * tr);
    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][r] = 0.f;

    for (int k0 = 0; k0 < d; k0 += KT) {
      const int kn = min(KT, d - k0);             // features of this stage
      const int octets = (kn + 7) >> 3;           // zero padded to a multiple of 8
      __syncthreads();                            // the last stage's reads are done
      // every copy of the stage in flight at once; zeros past d and ns
      for (int g = tid >> 5; g < SUB / 4; g += WARPS) {
        const float* src = xb + static_cast<size_t>(4 * g + sb) * d + k0 + skl;
        float* dst = xs + skl * SUB + 4 * (g ^ skl) + sb;
        for (int o = 0; o < octets; ++o) {
          const bool in = 8 * o + skl < kn;
          cp_async4(dst + 8 * o * SUB, in ? src + 8 * o : xb, in);
        }
      }
      for (int g = tid >> 5; 4 * g < ns; g += WARPS) {
        const int qi = 4 * g + sb;
        const float* src = q + static_cast<size_t>(qrow_s[s0 + min(qi, ns - 1)]) * d + k0 + skl;
        float* dst = qs + skl * P + 4 * (g ^ skl) + sb;
        for (int o = 0; o < octets; ++o) {
          const bool in = qi < ns && 8 * o + skl < kn;
          cp_async4(dst + 8 * o * P, in ? src + 8 * o : q, in);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (active) {
        for (int o = 0; o < octets; ++o) {
          const float* xk = xs + 8 * o * SUB;
          const float* qk = qs + 8 * o * P;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 xv = *reinterpret_cast<const float4*>(xk + j * SUB + 4 * (tr ^ j));
            const float4 qv = *reinterpret_cast<const float4*>(qk + j * P + 4 * (tq ^ j));
            const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              acc[m][0] = fmaf(qa[m], xv.x, acc[m][0]);
              acc[m][1] = fmaf(qa[m], xv.y, acc[m][1]);
              acc[m][2] = fmaf(qa[m], xv.z, acc[m][2]);
              acc[m][3] = fmaf(qa[m], xv.w, acc[m][3]);
            }
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int qi = 4 * tq + m;
        if (qi < ns) {
          const float4 o = make_float4(2.f * acc[m][0] - dn.x, 2.f * acc[m][1] - dn.y,
                                       2.f * acc[m][2] - dn.z, 2.f * acc[m][3] - dn.w);
          *reinterpret_cast<float4*>(out + static_cast<size_t>(slot_s[s0 + qi]) * SUB + 4 * tr) = o;
        }
      }
    }
    s0 = s1;
  }
}

// One warp a query (the query-stationary kernel, for selections that share
// almost no sub-chunks): the warp copies each of its query's selected
// sub-chunks into shared memory with 16-byte cp.async loads, in pieces of
// at most QUERY_PIECE floats, double-buffered; lane r sums row r, starting
// at a feature offset by its lane number for even d, which keeps the
// row-strided reads of shared memory free of bank conflicts.
__global__ void __launch_bounds__(QUERY_WARPS * 32)
by_query_kernel(const float* __restrict__ q, const float* __restrict__ data3,
                const float* __restrict__ dn2, const long long* __restrict__ top_sub,
                float* __restrict__ out, int nq, int ks, int d, int piece, int c32) {
  extern __shared__ __align__(16) float wsmem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= nq) return;                      // whole warps leave together

  const int dq = (d + 3) & ~3;              // q's row in shared memory, 16-byte multiple
  float* qs = wsmem + static_cast<size_t>(warp) * (dq + 2 * piece);
  float* bufs = qs + dq;                    // two pieces
  const int span = SUB * d;                 // floats of one sub-chunk
  const int npieces = (span + piece - 1) / piece;
  const int steps = ks * npieces;
  const long long* ids = top_sub + static_cast<size_t>(i) * ks;
  auto id = [&](int j) {                    // an id out of range reads sub-chunk 0, then NaN
    const long long c = ids[j];
    return c >= 0 && c < c32 ? c : 0ll;
  };

  for (int f = lane; f < d; f += 32) qs[f] = q[static_cast<size_t>(i) * d + f];

  // step t = (sub-chunk j, piece p): copy its floats [p * piece, +len)
  auto stage = [&](int t) {
    const int j = t / npieces, p = t - j * npieces;
    const float* src = data3 + static_cast<size_t>(id(j)) * span + static_cast<size_t>(p) * piece;
    const int len = min(piece, span - p * piece);           // a multiple of 4
    float* dst = bufs + (t & 1) * piece;
    for (int e = lane * 4; e < len; e += 128) cp_async16(dst + e, src + e);
  };

  stage(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int row0 = lane * d;                // this lane's row in the sub-chunk
  const int skew = (d & 1) ? 0 : lane;
  float acc = 0.f;
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) stage(t + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");   // empty at the last step
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();                           // piece t (and q) visible to all lanes
    const int j = t / npieces, p = t - j * npieces;
    const int p0 = p * piece;
    const int a = max(row0, p0);
    const int b = min(row0 + d, p0 + min(piece, span - p0));
    if (a < b) {
      const float* xb = bufs + (t & 1) * piece + (a - p0);
      const float* qb = qs + (a - row0);
      const int len = b - a;
      int u = skew % len;
      for (int s = 0; s < len; ++s) {
        acc = fmaf(qb[u], xb[u], acc);
        if (++u == len) u = 0;
      }
    }
    if (p == npieces - 1) {
      const long long c = ids[j];
      out[static_cast<size_t>(i) * ks * SUB + j * SUB + lane] =
          c >= 0 && c < c32 ? 2.f * acc - dn2[c * SUB + lane] : __int_as_float(0x7fffffff);
      acc = 0.f;
    }
    __syncwarp();                           // piece t's buffer is refilled at step t + 2
  }
}

// Whether a call of these shapes sorts the slots: from RESCORE_SORT_MIN
// slots a sub-chunk on average. Below it (a few queries against many
// sub-chunks) one warp a query is faster even on real, skewed selections:
// tools/k3_ab.py --inputs imbalanced, PERF.md.
bool sorts(long long n_slots, int c32) { return n_slots >= RESCORE_SORT_MIN * c32; }

}  // namespace

// The plan of a call from its shapes: 1 when it sorts the slots (a memset
// and three kernels, with scratch), 0 when it runs the query-stationary
// kernel alone (no scratch); *slots_per_item gets P, the sorted slots of a
// work item.
extern "C" int rescore_subchunks_sorts(int nq, int ks, int c32, int* slots_per_item) {
  *slots_per_item = P;
  return sorts(static_cast<long long>(nq) * ks, c32) ? 1 : 0;
}

// Launch on `stream` as rescore_subchunks_sorts plans it. Requires
// contiguous inputs, data3 and dn2 16-byte aligned, nq * ks < 2^31 and,
// for a call that sorts, `work` of 3 * nq * ks + 2 * (c32 + 1) ints, 8-byte
// aligned (ops/rescore_cuda.py::workspace_ints); otherwise `work` is not
// read and may be null. Returns the first error of cudaGetLastError()
// after each launch.
extern "C" int rescore_subchunks_launch(const float* q, const float* data3, const float* dn2,
                                        const long long* top_sub, float* out, int* work, int nq,
                                        int ks, int d, int c32, void* stream) {
  if (nq <= 0 || ks <= 0) return 0;
  if (d <= 0 || c32 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n64 = static_cast<long long>(nq) * ks;
  if (n64 >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_slots = static_cast<int>(n64);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;

  if (!sorts(n_slots, c32)) {
    const int span = SUB * d;
    const int piece = span < QUERY_PIECE ? span : QUERY_PIECE;
    const size_t per_warp = static_cast<size_t>(((d + 3) & ~3) + 2 * piece) * sizeof(float);
    int warps = static_cast<int>(SMEM_MAX / per_warp);
    if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (warps > QUERY_WARPS) warps = QUERY_WARPS;
    const size_t smem = per_warp * warps;
    err = cudaFuncSetAttribute(by_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    by_query_kernel<<<(nq + warps - 1) / warps, warps * 32, smem, st>>>(
        q, data3, dn2, top_sub, out, nq, ks, d, piece, c32);
    return static_cast<int>(cudaGetLastError());
  }

  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int2* sorted = reinterpret_cast<int2*>(work);
  int* rank = work + 2 * static_cast<size_t>(n_slots);
  int* counts = rank + n_slots;
  int* offsets = counts + c32 + 1;
  err = cudaMemsetAsync(counts, 0, (static_cast<size_t>(c32) + 1) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  bucket_count_kernel<<<(n_slots + COUNT_SLOTS - 1) / COUNT_SLOTS, COUNT_THREADS, 0, st>>>(
      top_sub, counts, rank, offsets, n_slots, c32);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bucket_scatter_kernel<<<(n_slots + 255) / 256, 256, 0, st>>>(top_sub, rank, offsets, sorted,
                                                               out, n_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int kcap = d < KT ? (d + 7) & ~7 : KT;
  const size_t smem = static_cast<size_t>(kcap) * (SUB + P) * sizeof(float);
  rescore_kernel<<<(n_slots + P - 1) / P, THREADS, smem, st>>>(q, data3, dn2, sorted, offsets,
                                                               out, ks, d, c32, kcap);
  return static_cast<int>(cudaGetLastError());
}
