// Pass 1 of the two-pass kNN with a separate norm vector, for Hopper (sm_90a).
//
// Replaces: benchmarks/knn_pass1_precision_probe.py, make_kernel(precision).kern
// (called through pass1).
//
// Contract, as pass1_scores gives it: q (nq, dp), x (nd, dp) fp32 and dn
// (nd,) fp32. The kernels give
//     out[c, j] = max over r in [32c, 32c + 32) of 2 * q[j].x[r] - dn[r],
// out (nd/32, nq), and the score matrix never reaches device memory. dn is
// its own input, not folded into feature columns as in chunk_max.cu, so a
// masked row carries dn = +inf and scores -inf. Three precisions, as the
// probe's:
//   bf16    (0): q and x rounded to bf16, one product, fp32 sums (what
//                Precision.DEFAULT does on the TPU);
//   high3   (1): hi = bf16(a), lo = bf16(a - hi); hh + hl + lh, exactly the
//                probe's manual 3-pass arithmetic;
//   highest (2): a three-way split and 6 products, equivalent to HIGHEST.
// Every product of two bf16 values is exact in fp32, so only the order of
// the fp32 sums differs from the plain version.
//
// Bound on this card: operations. 2 * nq * nd * dp flop per product on
// tensor cores at best: 98304^2 * 64 is 1.24e12 flop, 1.25 ms at 989
// TFLOP/s in bf16 (3.75 and 7.5 ms with 3 and 6 products), against 0.36 ms
// for writing the 1.2 GB output.
//
// Design:
//  * bf16: the fp32 operands are rounded to bf16 (to nearest even) once per
//    call, before the kernel, by the wrapper; then wgmma_pass1.cuh's
//    persistent wgmma + TMA kernel, the one K1's bf16 mode runs, with the
//    SeparateNorm epilogue: a CTA an SM keeps a 256-row data tile and its
//    256 dn values in shared memory, three consumer warpgroups load their
//    own 64-query tiles by TMA, every sum becomes fmaf(2, s, -dn[r]) before
//    the 32-row max, and the maxima are stored query-major, out (nq, nd/32);
//    the wrapper returns the (nd/32, nq) view.
//  * high3 / highest: split_mma.cuh's mainloop, which splits the operands
//    into their bf16 parts as it stages them, runs the 3 or 6 products on
//    the tensor cores (mma.sync m16n8k16) and walks each data tile over
//    several query tiles, with the epilogue 2 * sum - dn[r]; out (nd/32, nq).

#include <cstdint>

#include "split_mma.cuh"
#include "wgmma_pass1.cuh"

namespace {

enum Mode { kBf16 = 0, kHigh3 = 1, kHighest = 2 };

// the norm is its own vector, subtracted per row
struct SeparateNorm {
  const float* dn;
  // split_mma.cuh's epilogue
  __device__ float row(int r) const { return dn[r]; }
  __device__ float score(float s, float n) const { return 2.f * s - n; }
  // wgmma_pass1.cuh's: the row vector dn, subtracted before the max
  static constexpr bool kRowVector = true;
  __device__ static float finish(float m) { return m; }
};

}  // namespace

// Launch on `stream`. mode 0 (bf16): q and x bf16, out (nq, nd / 32) fp32,
// query-major; mode 1 (high3) and 2 (highest): q and x fp32, out (nd / 32,
// nq) fp32. dn is fp32 in every mode, 16-byte aligned in mode 0. Requires
// nq % 128 == 0, nd % 128 == 0, dp % 64 == 0 and row-major contiguous
// inputs with 16-byte aligned rows. Returns cudaGetLastError(), or in mode 0
// 10000 + the CUresult of a failed tensor-map encode.
extern "C" int pass1_norm_launch(const void* q, const void* x, const float* dn,
                                 float* out, int nq, int nd, int dp, int mode,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq % split_mma::BQ || nd % split_mma::BD || dp % split_mma::MBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  switch (mode) {
    case kBf16:
      if (reinterpret_cast<uintptr_t>(dn) % 16) return static_cast<int>(cudaErrorInvalidValue);
      return wgmma_pass1::launch(q, x, SeparateNorm{dn}, out, nq, nd, dp, s);
    case kHigh3:
      return split_mma::launch<2>(qf, xf, SeparateNorm{dn}, out, nq, nd, dp, s);
    case kHighest:
      return split_mma::launch<3>(qf, xf, SeparateNorm{dn}, out, nq, nd, dp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
