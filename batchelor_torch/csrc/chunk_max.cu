// Sub-chunk maxima of the kNN score matrix, for Hopper (sm_90a).
//
// Replaces: batchelor_tpu/ops/knn_pallas.py, _chunkmax_kernel (called
// through chunk_max_scores).
//
// Contract: q (nq, dp) and x (nd, dp), both fp32 or both bf16, with the data
// norms already folded into two feature columns (x carries (dn_hi, dn_lo),
// q carries (-0.5, -0.5)), so s[r, j] = 2 * sum_f q[j, f] * x[r, f] is the
// score 2 q.x - |x|^2. The kernel writes only the maxima
//     m[c, j] = max over r in [32c, 32c + 32) of s[r, j]
// and the score matrix never reaches device memory. The products follow the
// reference's arithmetic: bf16 inputs give one product of bf16 values; fp32
// inputs are split into bf16 parts, hi*hi + hi*lo + lo*hi (3 products), or
// with six_pass a three-way split and 6 products. Every product of two bf16
// values is exact in fp32, so only the order of the fp32 sums differs from
// the plain version.
//
// Bound on this card: operations. 2 * nq * nd * dp flop per product, on
// tensor cores at best: 100352^2 * 64 in bf16 is 1.29e12 flop, ~1.30 ms at
// 989 TFLOP/s (3.9 and 7.8 ms with 3 and 6 products), against 0.38 ms for
// writing the 1.26 GB of maxima at 3.35 TB/s.
//
// bf16 mode (the one "auto" takes): wgmma_pass1.cuh's persistent wgmma +
// TMA kernel, which K4's bf16 mode (pass1_norm.cu) shares, with the FoldedNorm
// epilogue below (2 x the max of the sums). A CTA an SM keeps a 256-row data
// tile in shared memory, three consumer warpgroups load their own 64-query
// tiles by TMA, and the maxima are stored query-major, out (nq, nd/32); the
// wrapper returns the (nd/32, nq) view. Masked rows' finite 1e30 norm scores
// about -1e30.
// fp32 modes (what "chunked" and exact_selection take): split_mma.cuh's
// mma.sync mainloop, which splits the operands into their bf16 parts as it
// stages them, runs the 3 or 6 products on the tensor cores and walks each
// data tile over several query tiles, with the epilogue 2 * sum; they store
// data-major, (nd/32, nq).

#include "split_mma.cuh"
#include "wgmma_pass1.cuh"

namespace {

enum Mode { kBf16 = 0, kSplit3 = 1, kSplit6 = 2 };

// norms are folded into the features: the score is twice the sum
struct FoldedNorm {
  // split_mma.cuh's epilogue
  __device__ float row(int) const { return 0.f; }
  __device__ float score(float s, float) const { return 2.f * s; }
  // wgmma_pass1.cuh's: no row vector, 2 x the max of the sums
  static constexpr bool kRowVector = false;
  __device__ static float finish(float m) { return 2.f * m; }
};

}  // namespace

// Launch on `stream`. mode 0: q, x bf16, out (nq, nd / 32) fp32,
// query-major; mode 1: fp32, 3 products, and mode 2: fp32, 6 products, out
// (nd / 32, nq) fp32. Requires nq % 128 == 0, nd % 128 == 0, dp % 64 == 0,
// row-major contiguous inputs with 16-byte aligned rows. Returns
// cudaGetLastError(), or in mode 0 10000 + the CUresult of a failed
// tensor-map encode.
extern "C" int chunk_max_launch(const void* q, const void* x, float* out,
                                int nq, int nd, int dp, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq % split_mma::BQ || nd % split_mma::BD || dp % split_mma::MBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  switch (mode) {
    case kBf16:
      return wgmma_pass1::launch(q, x, FoldedNorm{}, out, nq, nd, dp, s);
    case kSplit3:
      return split_mma::launch<2>(qf, xf, FoldedNorm{}, out, nq, nd, dp, s);
    case kSplit6:
      return split_mma::launch<3>(qf, xf, FoldedNorm{}, out, nq, nd, dp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
