// Tensor-core tiles shared by chunk_max.cu (K1) and pass1_norm.cu (K4), for
// Hopper (sm_90a): the mma.sync helpers, the 32-row max epilogue, and the
// one mainloop of both files' fp32 split modes.
//
// Replaces the SIMT split kernels of both files; the TPU kernels it stands
// for are batchelor_tpu/ops/knn_pallas.py:68 (_chunkmax_kernel, fp32 and
// six_pass modes) and benchmarks/knn_pass1_precision_probe.py:42 (high3,
// highest), which run their split products on the matrix unit.
//
// The split modes compute s[r, j] = sum_f q[j, f] * x[r, f] for fp32 q
// (nq, dp) and x (nd, dp), each operand split into PARTS bf16 parts as the
// reference splits them (batchelor_tpu/ops/knn_pallas.py:101-118): hi =
// bf16(a), lo = bf16(a - hi) and, with PARTS = 3, a third part
// bf16((a - hi) - lo). PARTS = 2 sums 3 products (hh + hl + lh), PARTS = 3
// sums 6 (hh + hm + mh + hl + mm + lh). Every product of two bf16 values is
// exact in fp32, so mma.sync m16n8k16 (bf16 in, fp32 sums) forms exactly the
// plain version's products; only the order and rounding of the sums differ.
// The caller's epilogue turns a sum into a score (K1: 2 s; K4: 2 s - dn[r])
// before the 32-row max.
//
// Bound: operations, 3 or 6 bf16 products of 2 * nq * nd * dp flop at 989
// TFLOP/s (3.9 and 7.8 ms at K1's 100352^2 x 64). The fp32 FMA units (67
// TFLOP/s) of the SIMT kernels this replaces could not come near it.
//
// Tiles: 8 warps per CTA, each a slab of 32 data rows, one sub-chunk, so
// its max needs only its own fragments and three shuffles. split3's slabs
// are 32 x 64 queries (CTA block 128 x 128); six_pass's are 32 x 32 (block
// 128 x 64), which leaves its 3-part fragments registers enough that two
// CTAs of 128 registers a thread fit an SM without spilling. Operands are
// staged in 64-feature steps: fp32 rows come in with 16-byte loads, are
// split, and are stored as bf16 parts with rows padded to 72 bf16, which
// keeps the ldmatrix fragment loads conflict-free, in dynamic shared memory
// (PARTS * (128 + block queries) rows * 144 bytes). Each fragment is loaded
// once per 16-feature k-step and used by every product it takes part in.
//
// Rounding: each k-step's products go into a fresh fragment (an mma with
// C = 0), the small cross products first and hh last, which is then added
// to the running sum, so they round at the magnitude of a 16-feature
// partial and not of the whole score.
//
// Query walk (dp == 64, the width of both paths): a CTA splits its data
// tile once and walks over SPLIT_MMA_QWALK query tiles, fetching the next
// tile's fp32 rows with cp.async while the current tile's products run.
// Other widths take one query tile per CTA and stage both operands per 64
// features. tools/split_walk_ab.py builds and times walk lengths against
// each other. wgmma and TMA, with warp specialisation, are the next step.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#ifndef SPLIT_MMA_QWALK
#define SPLIT_MMA_QWALK 16
#endif

namespace split_mma {

constexpr int BD = 128;                  // data rows per CTA
constexpr int BQ = 128;                  // queries per CTA of the bf16 kernels
constexpr int SUB = 32;                  // data rows per sub-chunk
constexpr int MBK = 64;                  // features per shared-memory step
constexpr int MLD = MBK + 8;             // padded row, in bf16
constexpr int WARPS_M = 4;               // warp slabs: 32 data rows x 64 queries
constexpr int kThreads = 256;
constexpr int kSmemPerSM = 228 * 1024;   // shared memory of an SM
constexpr int kSmemPerCTA = 1024;        // what the system reserves per CTA

__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
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

// the same with C = 0: a fresh fragment needs no zeroed registers
__device__ __forceinline__ void mma_16816_fresh(float (&d)[4], const unsigned (&a)[4],
                                                const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i of every lane gets its part of
// matrix i in the layout of an mma fragment
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A warp's 32 x (8 NT) sums as scores, max over each query's 32 rows,
// stored at out[c, q0 + wn * 8 NT ...] for the warp's sub-chunk c, where
// the CTA block's queries start at q0. Epi::row(r) loads
// what row r's score needs, Epi::score(s, row value) forms it. A fragment's
// d0/d1 are rows g (cols 2t, 2t+1), d2/d3 rows g + 8: max over the thread's
// 4 rows, then over the 8 row groups (lanes that differ in bits 2-4).
template <int NT, class Epi>
__device__ __forceinline__ void store_subchunk_max(const float (&acc)[2][NT][4], const Epi& epi,
                                                   float* __restrict__ out, int nq, int d0,
                                                   int q0, int wm, int wn, int g, int t) {
  const int r0 = d0 + wm * 32 + g;
  const float v00 = epi.row(r0), v01 = epi.row(r0 + 8);
  const float v10 = epi.row(r0 + 16), v11 = epi.row(r0 + 24);
  const int c = (d0 + wm * 32) / SUB;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float m0 = fmaxf(fmaxf(epi.score(acc[0][nt][0], v00), epi.score(acc[0][nt][2], v01)),
                     fmaxf(epi.score(acc[1][nt][0], v10), epi.score(acc[1][nt][2], v11)));
    float m1 = fmaxf(fmaxf(epi.score(acc[0][nt][1], v00), epi.score(acc[0][nt][3], v01)),
                     fmaxf(epi.score(acc[1][nt][1], v10), epi.score(acc[1][nt][3], v11)));
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    if (g == 0) {
      const int col = q0 + wn * NT * 8 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(c) * nq + col) = make_float2(m0, m1);
    }
  }
}

__device__ __forceinline__ unsigned pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// ROWS rows x 64 features of src (row stride ld floats, from row0, feature
// k0) split into PARTS bf16 tiles at dst, dst + ROWS * MLD, ...
template <int PARTS, int ROWS>
__device__ __forceinline__ void stage_split(const float* __restrict__ src, size_t ld, int row0,
                                            int k0, __nv_bfloat16* dst, int tid) {
#pragma unroll 2
  for (int e = tid; e < ROWS * (MBK / 4); e += kThreads) {
    const int r = e / (MBK / 4), c = (e % (MBK / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + (row0 + r) * ld + k0 + c);
    float rest[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      __nv_bfloat16 h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __float2bfloat16_rn(rest[i]);
        rest[i] -= __bfloat162float(h[i]);        // exact: a - bf16(a)
      }
      *reinterpret_cast<uint2*>(dst + (p * ROWS + r) * MLD + c) =
          make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
    }
  }
}

// acc += the split products of one 64-feature step of the staged parts.
// Fragments come by ldmatrix: an A fragment (16 rows x 16 features) is the
// matrices (rows 0-7 | 8-15) x (features 0-7 | 8-15); two neighbouring B
// fragments (8 queries x 16 features each) are (queries 0-7 | 8-15) x
// (features 0-7 | 8-15). xs and qs are shared-memory addresses, so every
// fragment's address is a constant offset from the lane's own.
template <int PARTS, int NT>
__device__ __forceinline__ void mma_step(float (&acc)[2][NT][4], const __nv_bfloat16* xs,
                                         const __nv_bfloat16* qs, int wm, int wn, int lane) {
  constexpr int kBQ = 2 * NT * 8;                   // queries of the CTA block
  constexpr unsigned kRow = MLD * 2;                // bytes per staged row
  const int arow = lane & 15, acol = (lane >> 4) * 8;                  // A: matrix lane / 8
  const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
  const unsigned xa = static_cast<unsigned>(__cvta_generic_to_shared(xs)) +
                      ((wm * 32 + arow) * MLD + acol) * 2;
  const unsigned qa = static_cast<unsigned>(__cvta_generic_to_shared(qs)) +
                      ((wn * NT * 8 + brow) * MLD + bcol) * 2;
#pragma unroll
  for (int kk = 0; kk < MBK; kk += 16) {
    unsigned a[PARTS][2][4];
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[p][mt], xa + (p * BD + mt * 16) * kRow + kk * 2);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {           // query fragments 2 np, 2 np + 1
      unsigned b[PARTS][2][2];
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        unsigned r[4];
        ldmatrix_x4(r, qa + (p * kBQ + np * 16) * kRow + kk * 2);
        b[p][0][0] = r[0]; b[p][0][1] = r[1]; b[p][1][0] = r[2]; b[p][1][1] = r[3];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float part[4];
          if constexpr (PARTS == 3) {               // third-order terms first
            mma_16816_fresh(part, a[2][mt], b[0][h]);
            mma_16816(part, a[1][mt], b[1][h]);
            mma_16816(part, a[0][mt], b[2][h]);
            mma_16816(part, a[1][mt], b[0][h]);     // then x_lo q_hi
          } else {
            mma_16816_fresh(part, a[1][mt], b[0][h]);
          }
          mma_16816(part, a[0][mt], b[1][h]);       // x_hi q_lo
          mma_16816(part, a[0][mt], b[0][h]);       // x_hi q_hi last
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][np * 2 + h][e] += part[e];
        }
    }
  }
}

// Query fragments of 8 per warp slab: 32 x 64 slabs for split3, 32 x 32
// for six_pass (see the note at the top).
template <int PARTS>
__host__ __device__ constexpr int slab_nt() { return PARTS == 3 ? 4 : 8; }

template <int PARTS>
__host__ __device__ constexpr int block_q() { return 2 * slab_nt<PARTS>() * 8; }

// the bf16 parts of both tiles, and on a walk the raw fp32 query tile
// fetched ahead
template <int PARTS, int QWALK>
constexpr int smem_bytes() {
  return PARTS * (BD + block_q<PARTS>()) * MLD * 2 + (QWALK > 1 ? block_q<PARTS>() * MBK * 4 : 0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// one ROWS x 64 fp32 query tile into raw shared memory, asynchronously
template <int ROWS>
__device__ __forceinline__ void fetch_tile(const float* __restrict__ q, int q0, float* raw,
                                           int tid) {
  for (int e = tid; e < ROWS * (MBK / 4); e += kThreads)
    cp_async16(raw + e * 4, q + static_cast<size_t>(q0) * MBK + e * 4);
  asm volatile("cp.async.commit_group;\n" ::);
}

// out[c, j] = max over the 32 rows r of sub-chunk c of epi.score(s[r, j],
// epi.row(r)), with s the split products of q and x. The grid walks query
// tiles fastest, so neighbouring CTAs share a data tile.
template <int PARTS, int QWALK, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
split_mma_kernel(const float* __restrict__ q, const float* __restrict__ x, Epi epi,
                 float* __restrict__ out, int nq, int nd, int dp) {
  constexpr int NT = slab_nt<PARTS>(), kBQ = block_q<PARTS>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = xs + PARTS * BD * MLD;

  const int nqb = nq / kBQ;
  const int nwalk = (nqb + QWALK - 1) / QWALK;
  const int qb0 = (blockIdx.x % nwalk) * QWALK;
  const int d0 = (blockIdx.x / nwalk) * BD;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M;            // data rows wm*32 .. wm*32+31
  const int wn = warp / WARPS_M;            // queries wn*NT*8 ...
  const int g = lane >> 2, t = lane & 3;    // fragment row group, thread in group

  float acc[2][NT][4];
  if constexpr (QWALK == 1) {
    const int q0 = qb0 * kBQ;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int k0 = 0; k0 < dp; k0 += MBK) {
      stage_split<PARTS, BD>(x, dp, d0, k0, xs, tid);
      stage_split<PARTS, kBQ>(q, dp, q0, k0, qs, tid);
      __syncthreads();
      mma_step<PARTS>(acc, xs, qs, wm, wn, lane);
      __syncthreads();
    }
    store_subchunk_max(acc, epi, out, nq, d0, q0, wm, wn, g, t);
  } else {
    // the walk (dp == MBK): the data tile's parts stay; each query tile is
    // split from raw shared memory, where the next one is already on its way
    float* raw = reinterpret_cast<float*>(qs + PARTS * kBQ * MLD);
    const int qb1 = min(qb0 + QWALK, nqb);
    fetch_tile<kBQ>(q, qb0 * kBQ, raw, tid);
    stage_split<PARTS, BD>(x, MBK, d0, 0, xs, tid);
    for (int qb = qb0; qb < qb1; ++qb) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();                      // raw is whole; the last tile's products are done
      stage_split<PARTS, kBQ>(raw, MBK, 0, 0, qs, tid);
      __syncthreads();                      // qs is whole; raw is free
      if (qb + 1 < qb1) fetch_tile<kBQ>(q, (qb + 1) * kBQ, raw, tid);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      mma_step<PARTS>(acc, xs, qs, wm, wn, lane);
      store_subchunk_max(acc, epi, out, nq, d0, qb * kBQ, wm, wn, g, t);
    }
  }
}

template <int PARTS, int QWALK, class Epi>
int launch_walk(const float* q, const float* x, Epi epi, float* out, int nq, int nd, int dp,
                cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>((nq / block_q<PARTS>() + QWALK - 1) / QWALK) * (nd / BD);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = split_mma_kernel<PARTS, QWALK, Epi>;
  constexpr int bytes = smem_bytes<PARTS, QWALK>();
  static_assert(2 * (bytes + kSmemPerCTA) <= kSmemPerSM,
                "two CTAs an SM: one stages while the other multiplies");
  // above the 48 KB default; set on every launch, since it holds per device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(q, x, epi, out, nq, nd, dp);
  return static_cast<int>(cudaGetLastError());
}

// Launch the split mainloop with PARTS parts and the caller's epilogue on
// `stream`; nq and nd multiples of 128, dp a multiple of 64, rows 16-byte
// aligned. Returns a cudaError_t: the shared-memory attribute's, else the
// launch's.
template <int PARTS, class Epi>
int launch(const float* q, const float* x, Epi epi, float* out, int nq, int nd, int dp,
           cudaStream_t stream) {
  if (dp == MBK) return launch_walk<PARTS, SPLIT_MMA_QWALK>(q, x, epi, out, nq, nd, dp, stream);
  return launch_walk<PARTS, 1>(q, x, epi, out, nq, nd, dp, stream);
}

}  // namespace split_mma
