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
// memory.
//
// Bound on this card: at the main path's shape (nq = 100,000, ks = 20,
// d = 50) operations and bytes are close: 6.4e9 fp32 flop (0.1 ms at 67
// TFLOP/s) against ~0.3 GB of unique bytes, dominated by the 256 MB score
// write (0.09 ms at 3.35 TB/s). The gather itself reads 12.8 GB, but of a
// 20 MB data3 that stays in the 50 MB L2, so the L2 rate, not device
// memory, limits a kernel that reads every selected block once per query.
//
// Design: one warp per query. A sub-chunk is one contiguous block of
// 32 * d floats (128 * d bytes, so its base is 16-byte aligned); the warp
// copies it into shared memory with 16-byte cp.async loads, in pieces of at
// most 8 KB, double-buffered so the next piece is in flight while this one
// is used. Lane r then owns row r: it sums q . x_r over the part of its row
// in the piece, reading q from shared memory too. For even d the lanes
// start their sums at a feature offset by their lane number, which makes
// the row-strided shared-memory reads conflict-free (for odd d the stride
// already is). Any d works; the norm is subtracted when a sub-chunk's last
// piece is done, and the 32 lanes store their scores as one 128-byte row.

#include <cuda_runtime.h>

namespace {

constexpr int SUB = 32;               // data rows per sub-chunk
constexpr int kMaxWarps = 4;          // warps (queries) per CTA
constexpr int kMaxPiece = 2048;       // floats of a sub-chunk staged at once
constexpr int kSmemMax = 227 * 1024;  // shared memory a CTA can use

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
rescore_kernel(const float* __restrict__ q, const float* __restrict__ data3,
               const float* __restrict__ dn2, const long long* __restrict__ top_sub,
               float* __restrict__ out, int nq, int ks, int d, int piece) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= nq) return;                      // whole warps leave together

  const int dq = (d + 3) & ~3;              // q's row in shared memory, 16-byte multiple
  float* qs = smem + static_cast<size_t>(warp) * (dq + 2 * piece);
  float* bufs = qs + dq;                    // two pieces
  const int span = SUB * d;                 // floats of one sub-chunk
  const int npieces = (span + piece - 1) / piece;
  const int steps = ks * npieces;
  const long long* ids = top_sub + static_cast<size_t>(i) * ks;

  for (int f = lane; f < d; f += 32) qs[f] = q[static_cast<size_t>(i) * d + f];

  // step t = (sub-chunk j, piece p): copy its floats [p * piece, +len)
  auto stage = [&](int t) {
    const int j = t / npieces, p = t - j * npieces;
    const float* src = data3 + static_cast<size_t>(ids[j]) * span + static_cast<size_t>(p) * piece;
    const int len = min(piece, span - p * piece);           // a multiple of 4
    float* dst = bufs + (t & 1) * piece;
    for (int e = lane * 4; e < len; e += 128) cp_async16(dst + e, src + e);
  };

  stage(0);
  cp_async_commit();
  const int row0 = lane * d;                // this lane's row in the sub-chunk
  const int skew = (d & 1) ? 0 : lane;
  float acc = 0.f;
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) stage(t + 1);
    cp_async_commit();                      // an empty group at the last step
    cp_async_wait_one();
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
      const size_t c = static_cast<size_t>(ids[j]);
      out[static_cast<size_t>(i) * ks * SUB + j * SUB + lane] = 2.f * acc - dn2[c * SUB + lane];
      acc = 0.f;
    }
    __syncwarp();                           // piece t's buffer is refilled at step t + 2
  }
}

}  // namespace

// Launch on `stream`. Requires contiguous inputs, data3 16-byte aligned and
// ids in [0, c32). Returns cudaGetLastError() (or cudaErrorInvalidValue if
// a warp's buffers for this d do not fit in shared memory).
extern "C" int rescore_subchunks_launch(const float* q, const float* data3, const float* dn2,
                                        const long long* top_sub, float* out, int nq, int ks,
                                        int d, void* stream) {
  if (nq <= 0 || ks <= 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int span = SUB * d;
  const int piece = span < kMaxPiece ? span : kMaxPiece;
  const size_t per_warp = static_cast<size_t>(((d + 3) & ~3) + 2 * piece) * sizeof(float);
  int warps = static_cast<int>(kSmemMax / per_warp);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const size_t smem = per_warp * warps;
  cudaError_t err = cudaFuncSetAttribute(rescore_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((nq + warps - 1) / warps);
  rescore_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, data3, dn2, top_sub, out, nq, ks, d, piece);
  return static_cast<int>(cudaGetLastError());
}
