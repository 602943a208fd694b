// Pass 1 of the two-pass kNN with a separate norm vector, for Hopper (sm_90a).
//
// Replaces: benchmarks/knn_pass1_precision_probe.py, make_kernel(precision).kern
// (called through pass1).
//
// Contract: q (nq, dp), x (nd, dp) fp32 and dn (nd,) fp32. The kernel writes
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
// Design: the tiles of chunk_max.cu (split_mma.cuh). Every CTA computes a
// block of 128 data rows x 128 queries (64 with highest) on tensor cores
// (mma.sync m16n8k16) and keeps only its 32-row maxima; the norm is
// subtracted in the epilogue, before the max.
//  * bf16: the fp32 operands are rounded to bf16 as they are staged in
//    shared memory (rows padded to 72 bf16 for conflict-free fragment
//    loads).
//  * high3 / highest: split_mma.cuh's mainloop, which splits the operands
//    into their bf16 parts as it stages them, runs the 3 or 6 products on
//    the tensor cores and walks each data tile over several query tiles,
//    with the epilogue 2 * sum - dn[r].
// No TMA, wgmma or warp specialisation yet; they are the next step.

#include "split_mma.cuh"

namespace {

using namespace split_mma;

enum Mode { kBf16 = 0, kHigh3 = 1, kHighest = 2 };

// the norm is its own vector, subtracted per row
struct SeparateNorm {
  const float* dn;
  __device__ float row(int r) const { return dn[r]; }
  __device__ float score(float s, float n) const { return 2.f * s - n; }
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// 8 fp32 values at p (32-byte aligned) as 8 bf16 values, rounded to nearest
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack_bf16(u.x, u.y), pack_bf16(u.z, u.w),
                    pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__global__ void __launch_bounds__(kThreads)
pass1_bf16_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ dn, float* __restrict__ out,
                  int nq, int nd, int dp) {
  __shared__ __align__(16) __nv_bfloat16 xs[BD][MLD];
  __shared__ __align__(16) __nv_bfloat16 qs[BQ][MLD];

  const int nqb = nq / BQ;
  const int q0 = (blockIdx.x % nqb) * BQ;
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
    for (int e = tid; e < BD * (MBK / 8); e += kThreads) {   // 8 values per step
      const int r = e / (MBK / 8), c = (e % (MBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&xs[r][c]) =
          load8_bf16(x + static_cast<size_t>(d0 + r) * dp + k0 + c);
      *reinterpret_cast<uint4*>(&qs[r][c]) =
          load8_bf16(q + static_cast<size_t>(q0 + r) * dp + k0 + c);
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
  store_subchunk_max(acc, SeparateNorm{dn}, out, nq, d0, q0, wm, wn, g, t);
}

int launch_bf16(const float* q, const float* x, const float* dn, float* out, int nq, int nd,
                int dp, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(nq / BQ) * (nd / BD);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  pass1_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(q, x, dn, out, nq,
                                                                             nd, dp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`. mode 0: bf16, 1: high3, 2: highest. Requires
// nq % 128 == 0, nd % 128 == 0, dp % 64 == 0 and row-major contiguous fp32
// inputs with 16-byte aligned rows; out is (nd / 32, nq) fp32. Returns
// cudaGetLastError().
extern "C" int pass1_norm_launch(const float* q, const float* x, const float* dn,
                                 float* out, int nq, int nd, int dp, int mode,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq % BQ || nd % BD || dp % MBK) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kBf16:
      return launch_bf16(q, x, dn, out, nq, nd, dp, s);
    case kHigh3:
      return split_mma::launch<2>(q, x, SeparateNorm{dn}, out, nq, nd, dp, s);
    case kHighest:
      return split_mma::launch<3>(q, x, SeparateNorm{dn}, out, nq, nd, dp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
