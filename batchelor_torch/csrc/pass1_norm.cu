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
// Design: the tiles of chunk_max.cu. Every CTA computes a 128 data rows x
// 128 queries block on chip and keeps only its 32-row maxima; the norm is
// subtracted in the epilogue, before the max.
//  * bf16: tensor cores through mma.sync m16n8k16. The fp32 operands are
//    rounded to bf16 as they are staged in shared memory (rows padded to 72
//    bf16 for conflict-free fragment loads). A warp's 32 rows are one
//    sub-chunk, so its max is over its own fragments and three shuffles.
//  * high3 / highest: a tiled SIMT product on the fp32 FMA units, 8 x 8
//    register tiles, operands split into their bf16 parts as they are
//    staged; each 16-feature (8 for highest) block is summed into a fresh
//    partial before it is added, which keeps the rounding near the plain
//    version's separate products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>

namespace {

constexpr int BD = 128;      // data rows per CTA
constexpr int BQ = 128;      // queries per CTA
constexpr int TM = 8;        // data rows per thread
constexpr int TN = 8;        // queries per thread
constexpr int SUB = 32;      // data rows per sub-chunk
constexpr int PAD = 4;       // shared-memory row padding (keeps float4 alignment)
constexpr int kThreads = (BD / TM) * (BQ / TN);   // 256

enum Mode { kBf16 = 0, kHigh3 = 1, kHighest = 2 };

template <int MODE> struct Cfg;
template <> struct Cfg<kHigh3> { static constexpr int parts = 2, bk = 16; };
template <> struct Cfg<kHighest> { static constexpr int parts = 3, bk = 8; };

__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// a as PARTS bf16 values: hi = bf16(a), then bf16 of what remains
template <int PARTS>
__device__ __forceinline__ void split(float a, float (&p)[3]) {
  p[0] = bf16_round(a);
  const float r = a - p[0];
  p[1] = bf16_round(r);
  if (PARTS == 3) p[2] = bf16_round(r - p[1]);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
pass1_split_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   const float* __restrict__ dn, float* __restrict__ out,
                   int nq, int nd, int dp) {
  constexpr int PARTS = Cfg<MODE>::parts;
  constexpr int BK = Cfg<MODE>::bk;
  __shared__ __align__(16) float xs[PARTS][BK][BD + PAD];
  __shared__ __align__(16) float qs[PARTS][BK][BQ + PAD];

  const int nqb = nq / BQ;
  const int q0 = (blockIdx.x % nqb) * BQ;   // neighbouring CTAs share a data tile
  const int d0 = (blockIdx.x / nqb) * BD;
  const int tid = threadIdx.x;
  const int tr = tid & 15;                  // data rows tr*8 .. tr*8+7
  const int tc = tid >> 4;                  // queries tc*8 .. tc*8+7

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < dp; k0 += BK) {
    for (int e = tid; e < BD * BK; e += kThreads) {
      const int r = e / BK, f = e % BK;
      float p[3];
      split<PARTS>(x[static_cast<size_t>(d0 + r) * dp + k0 + f], p);
#pragma unroll
      for (int s = 0; s < PARTS; ++s) xs[s][f][r] = p[s];
    }
    for (int e = tid; e < BQ * BK; e += kThreads) {
      const int r = e / BK, f = e % BK;
      float p[3];
      split<PARTS>(q[static_cast<size_t>(q0 + r) * dp + k0 + f], p);
#pragma unroll
      for (int s = 0; s < PARTS; ++s) qs[s][f][r] = p[s];
    }
    __syncthreads();

    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int f = 0; f < BK; ++f) {
      float a[PARTS][TM], b[PARTS][TN];
#pragma unroll
      for (int s = 0; s < PARTS; ++s) {
        const float4* xa = reinterpret_cast<const float4*>(&xs[s][f][tr * TM]);
        const float4* qa = reinterpret_cast<const float4*>(&qs[s][f][tc * TN]);
        const float4 x0 = xa[0], x1 = xa[1], y0 = qa[0], y1 = qa[1];
        a[s][0] = x0.x; a[s][1] = x0.y; a[s][2] = x0.z; a[s][3] = x0.w;
        a[s][4] = x1.x; a[s][5] = x1.y; a[s][6] = x1.z; a[s][7] = x1.w;
        b[s][0] = y0.x; b[s][1] = y0.y; b[s][2] = y0.z; b[s][3] = y0.w;
        b[s][4] = y1.x; b[s][5] = y1.y; b[s][6] = y1.z; b[s][7] = y1.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float v = part[i][j];
          v = fmaf(a[0][i], b[0][j], v);                // hh + hl + lh
          v = fmaf(a[0][i], b[1][j], v);
          v = fmaf(a[1][i], b[0][j], v);
          if (MODE == kHighest) {                       // + hm + mm + lm terms
            v = fmaf(a[0][i], b[2][j], v);
            v = fmaf(a[1][i], b[1][j], v);
            v = fmaf(a[2][i], b[0][j], v);
          }
          part[i][j] = v;
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  // score = 2 acc - dn per row; max over this thread's 8 rows, then over the
  // 4 lanes of its sub-chunk (lanes that differ in their two low bits)
  float dnr[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) dnr[i] = dn[d0 + tr * TM + i];
  float m[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float v = 2.f * acc[0][j] - dnr[0];
#pragma unroll
    for (int i = 1; i < TM; ++i) v = fmaxf(v, 2.f * acc[i][j] - dnr[i]);
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    m[j] = v;
  }
  if ((tr & 3) == 0) {
    const int c = (d0 + tr * TM) / SUB;
    float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(c) * nq + q0 + tc * TN);
    o[0] = make_float4(m[0], m[1], m[2], m[3]);
    o[1] = make_float4(m[4], m[5], m[6], m[7]);
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16) ----

constexpr int MBK = 64;                  // features per shared-memory step
constexpr int MLD = MBK + 8;             // padded row, in bf16
constexpr int WARPS_M = 4;               // warp slabs: 32 data rows x 64 queries

__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

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

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

  // a fragment's d0/d1 are rows g (cols 2t, 2t+1), d2/d3 rows g + 8; score
  // = 2 acc - dn per row, max over the thread's 4 rows, then over the 8 row
  // groups (lanes that differ in bits 2-4)
  const int r0 = d0 + wm * 32 + g;
  const float dn00 = dn[r0], dn01 = dn[r0 + 8], dn10 = dn[r0 + 16], dn11 = dn[r0 + 24];
  const int c = (d0 + wm * 32) / SUB;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float m0 = fmaxf(fmaxf(2.f * acc[0][nt][0] - dn00, 2.f * acc[0][nt][2] - dn01),
                     fmaxf(2.f * acc[1][nt][0] - dn10, 2.f * acc[1][nt][2] - dn11));
    float m1 = fmaxf(fmaxf(2.f * acc[0][nt][1] - dn00, 2.f * acc[0][nt][3] - dn01),
                     fmaxf(2.f * acc[1][nt][1] - dn10, 2.f * acc[1][nt][3] - dn11));
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    if (g == 0) {
      const int col = q0 + wn * 64 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(c) * nq + col) = make_float2(m0, m1);
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, float*, int, int, int);

int launch(KernelFn kernel, const float* q, const float* x, const float* dn, float* out,
           int nq, int nd, int dp, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(nq / BQ) * (nd / BD);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(q, x, dn, out, nq, nd, dp);
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
      return launch(pass1_bf16_kernel, q, x, dn, out, nq, nd, dp, s);
    case kHigh3:
      return launch(pass1_split_kernel<kHigh3>, q, x, dn, out, nq, nd, dp, s);
    case kHighest:
      return launch(pass1_split_kernel<kHighest>, q, x, dn, out, nq, nd, dp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
