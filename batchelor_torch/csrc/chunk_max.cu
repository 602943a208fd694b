// Sub-chunk maxima of the kNN score matrix, for Hopper (sm_90a).
//
// Replaces: batchelor_tpu/ops/knn_pallas.py, _chunkmax_kernel (called
// through chunk_max_scores).
//
// Contract: q (nq, dp) and x (nd, dp), both fp32 or both bf16, with the data
// norms already folded into two feature columns (x carries (dn_hi, dn_lo),
// q carries (-0.5, -0.5)), so s[r, j] = 2 * sum_f q[j, f] * x[r, f] is the
// score 2 q.x - |x|^2. The kernel writes only
//     out[c, j] = max over r in [32c, 32c + 32) of s[r, j],   out (nd/32, nq)
// and the score matrix never reaches device memory. The products follow the
// reference's arithmetic: bf16 inputs give one product of bf16 values; fp32
// inputs are split into bf16 parts, hi*hi + hi*lo + lo*hi (3 products), or
// with six_pass a three-way split and 6 products. Every product of two bf16
// values is exact in fp32, so only the order of the fp32 sums differs from
// the plain version.
//
// Bound on this card: operations. 2 * nq * nd * dp flop per product, on
// tensor cores at best: 100352^2 * 64 in bf16 is 1.29e12 flop, ~1.3 ms at
// 989 TFLOP/s (3.9 and 7.8 ms with 3 and 6 products), against 0.38 ms for
// writing the 1.26 GB output.
//
// Design. Every CTA computes a block of 128 data rows x 128 queries (64
// with six_pass) on tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums)
// and keeps it on chip; each of 8 warps owns a slab of 32 rows, one
// sub-chunk, so the 32-row max is taken in registers and by warp shuffles
// and only the (nd/32, nq) maxima are stored (split_mma.cuh).
//  * bf16 mode (the one "auto" takes): operands staged in shared memory in
//    64-feature steps, rows padded to 72 bf16 for conflict-free fragment
//    loads.
//  * fp32 modes (what "chunked" and exact_selection take): split_mma.cuh's
//    mainloop, which splits the operands into their bf16 parts as it
//    stages them, runs the 3 or 6 products on the tensor cores and walks
//    each data tile over several query tiles, with the epilogue 2 * sum.
// No TMA, wgmma or warp specialisation yet; they are the next step.

#include "split_mma.cuh"

namespace {

using namespace split_mma;

enum Mode { kBf16 = 0, kSplit3 = 1, kSplit6 = 2 };

// norms are folded into the features: the score is twice the sum
struct FoldedNorm {
  __device__ float row(int) const { return 0.f; }
  __device__ float score(float s, float) const { return 2.f * s; }
};

__global__ void __launch_bounds__(kThreads)
chunk_max_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ x,
                      float* __restrict__ out, int nq, int nd, int dp) {
  __shared__ __align__(16) __nv_bfloat16 xs[BD][MLD];
  __shared__ __align__(16) __nv_bfloat16 qs[BQ][MLD];

  const int nqb = nq / BQ;
  const int q0 = (blockIdx.x % nqb) * BQ;   // neighbouring CTAs share a data tile
  const int d0 = (blockIdx.x / nqb) * BD;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M;            // data rows wm*32 .. wm*32+31
  const int wn = warp / WARPS_M;            // queries wn*64 .. wn*64+63
  const int g = lane >> 2, t = lane & 3;    // fragment row group, thread in group

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < dp; k0 += MBK) {
    for (int e = tid; e < BD * (MBK / 8); e += kThreads) {   // 16-byte chunks
      const int r = e / (MBK / 8), c = (e % (MBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&xs[r][c]) =
          *reinterpret_cast<const uint4*>(x + static_cast<size_t>(d0 + r) * dp + k0 + c);
      *reinterpret_cast<uint4*>(&qs[r][c]) =
          *reinterpret_cast<const uint4*>(q + static_cast<size_t>(q0 + r) * dp + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MBK; kk += 16) {
      unsigned a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        a[mt][0] = ld_pair(&xs[r][kk + 2 * t]);
        a[mt][1] = ld_pair(&xs[r + 8][kk + 2 * t]);
        a[mt][2] = ld_pair(&xs[r][kk + 8 + 2 * t]);
        a[mt][3] = ld_pair(&xs[r + 8][kk + 8 + 2 * t]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = wn * 64 + nt * 8 + g;
        b[nt][0] = ld_pair(&qs[n][kk + 2 * t]);
        b[nt][1] = ld_pair(&qs[n][kk + 8 + 2 * t]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_16816(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }
  store_subchunk_max(acc, FoldedNorm{}, out, nq, d0, q0, wm, wn, g, t);
}

int launch_bf16(const void* q, const void* x, float* out, int nq, int nd, int dp,
                cudaStream_t stream) {
  const long long blocks = static_cast<long long>(nq / BQ) * (nd / BD);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  chunk_max_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), out, nq, nd,
      dp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`. mode 0: q, x bf16; mode 1: fp32, 3 products; mode 2:
// fp32, 6 products. Requires nq % 128 == 0, nd % 128 == 0, dp % 64 == 0,
// row-major contiguous inputs with 16-byte aligned rows; out is (nd / 32, nq)
// fp32. Returns cudaGetLastError().
extern "C" int chunk_max_launch(const void* q, const void* x, float* out,
                                int nq, int nd, int dp, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq % BQ || nd % BD || dp % MBK) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  switch (mode) {
    case kBf16:
      return launch_bf16(q, x, out, nq, nd, dp, s);
    case kSplit3:
      return split_mma::launch<2>(qf, xf, FoldedNorm{}, out, nq, nd, dp, s);
    case kSplit6:
      return split_mma::launch<3>(qf, xf, FoldedNorm{}, out, nq, nd, dp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
