// The persistent wgmma + TMA mainloop of both pass-1 kernels' bf16 modes,
// for Hopper (sm_90a): K1 (chunk_max.cu, the norms folded into two feature
// columns) and K4 (pass1_norm.cu, the norms a separate vector). The kernel
// is templated on the caller's epilogue, which turns a sum s[r, j] = sum_f
// q[j, f] * x[r, f] of bf16 products into a score before the 32-row max:
//  * Epi::kRowVector false (K1's FoldedNorm): the score is 2 s, so the
//    kernel takes the max of the sums and Epi::finish doubles it;
//  * Epi::kRowVector true (K4's SeparateNorm): the score is 2 s - dn[r] for
//    an fp32 vector epi.dn of nd values. Each data tile's 256 values come
//    into shared memory beside it (1 KB), and every sum becomes
//    fmaf(2, s, -dn[r]) before the max: 2 s is exact, so the score rounds
//    once, as the plain version's 2 s - dn does, and a masked row's dn =
//    +inf scores -inf. Epi::finish leaves the max as it is.
// Both write out[j, c] = max over r in [32c, 32c + 32) of the score for
// bf16 q (nq, dp) and x (nd, dp), query-major (nq, nd/32); the score matrix
// never reaches device memory.
//
// Bound on this card: operations. 2 * nq * nd * dp flop, on tensor cores at
// best: 100352^2 * 64 is 1.29e12 flop, ~1.30 ms at 989 TFLOP/s, against
// 0.38 ms for writing the 1.26 GB of maxima at 3.35 TB/s.
//
// Design:
//  * Persistent CTAs, one an SM. A CTA owns a tile of 256 data rows (wgmma's
//    N), loaded once by TMA and kept in shared memory, and walks 64-query
//    tiles (wgmma's M) against it, so each query byte read from L2 feeds 256
//    data rows (~5 GB of L2 reads per 100352^2 x 64 call, against ~20 GB
//    when every 128 x 128 block re-read both operands). Work units are
//    (data tile, range of query tiles); the ranges split the queries only
//    where the data tiles alone leave SMs idle.
//  * Three consumer warpgroups, each with its own tiles and a 128-float
//    accumulator, and no producer warpgroup. Measured on an H100 (NVIDIA
//    H100 80GB HBM3, 700 W; tools/k1_bf16_ab.py): one warpgroup's chain of
//    products alone runs the tensor cores at about half rate, two at ~92% of
//    peak (1.41 ms without the epilogue), and the epilogue's 128 fp32 max a
//    thread and tile takes ~0.77 ms of the call when it runs alone. With two
//    consumers (and a TMA producer warpgroup, setmaxnreg) their products
//    interleave, finish together, and both epilogues fall in one gap: 2.0
//    ms, however they take turns. A third accumulator lets two consumers'
//    products run while the third reduces and stores: 1.81-1.85 ms. A
//    producer warpgroup beside three consumers would cap a thread at 128
//    registers (512 threads), too few for the accumulator, so each consumer
//    loads its own query tiles by TMA, 4 stages ahead, from one elected
//    thread with predicated instructions.
//  * Queries on M and data rows on N, both K-major in 128-byte swizzle (a
//    64-feature row is 128 bytes), so in the accumulator a thread holds 8 of
//    each sub-chunk's 32 columns for each of its two rows and its quad holds
//    the rest: the 32-row max is 7 fmaxf in registers and a reduce-scatter
//    over the quad (xor 2, then xor 1), which leaves each thread two
//    neighbouring sub-chunks of both rows, stored as float2. With a row
//    vector, a thread's columns 8j + 2t, 8j + 2t + 1 read their dn pair as
//    one float2 from shared memory in the epilogue (threads of one t read
//    one address: a broadcast), rather than holding 64 more registers. That
//    adds 128 FFMA and 32 shared loads a thread and tile to the epilogue,
//    and the third consumer no longer hides it: at 98304^2 x 64 the kernel
//    takes ~2.4 ms, against ~1.9 ms without both and ~2.2 ms with the FFMA
//    alone (tools/k4_bf16_ab.py with edited copies of this file, same card).
//  * The maxima are stored query-major, so a query's 8 maxima of a tile are
//    32 contiguous bytes and the selection reads rows without a transpose;
//    the wrappers return the (nd/32, nq) view.
//  * Every branch around wgmma is warp-uniform and every barrier wait,
//    arrive, load and store around it one (predicated) asm statement: ptxas
//    serializes the wgmma of code it sees as divergent (warning C7520).
//  * Shapes: nq and nd multiples of 128, dp a multiple of 64. A last data
//    tile of 128 rows reads zeros past nd (TMA's fill), which would score 0
//    and beat every real (negative) score, so sub-chunks at or past nd/32
//    are never stored; query tiles never cross nq. The row vector is copied
//    only up to nd, and its stale rest feeds only those sub-chunks. Up to
//    dp = 256 the data tile stays resident (4 k-blocks of 32 KB beside three
//    32 KB rings); wider operands stream the data tile's k-blocks with each
//    query k-block through one 40 KB stage a consumer. The data tile and the
//    row vector arrive on data_full and are freed on data_empty, so the
//    streaming path takes its row vector once per unit through the same two
//    barriers.

#pragma once

#include "tma_wgmma.cuh"

namespace wgmma_pass1 {

using namespace tma_wgmma;

constexpr int kTileD = 256;                  // data rows per CTA tile: wgmma's N
constexpr int kTileQ = 64;                   // queries per tile: wgmma's M
constexpr int kFeat = 64;                    // features per k-block: one 128-byte row
constexpr int kResidentKB = 4;               // data tiles of up to 256 features stay
constexpr int kConsumers = 3;
constexpr int kThreads = 128 * kConsumers;
constexpr uint32_t kQBlock = kTileQ * kFeat * 2;   // 8 KB
constexpr uint32_t kXBlock = kTileD * kFeat * 2;   // 32 KB
constexpr int kEncodeError = 10000;          // + the CUresult of a failed tensor-map encode

template <bool kResident>
struct Ring {
  static constexpr int kStages = kResident ? 4 : 1;
  static constexpr uint32_t kStage = kResident ? kQBlock : kQBlock + kXBlock;
};

// shared-memory bytes of an epilogue's row vector: one float a tile row
template <class Epi>
__host__ __device__ constexpr uint32_t row_bytes() {
  return Epi::kRowVector ? kTileD * 4 : 0;
}

struct Barriers {
  uint64_t full[kConsumers][4];
  uint64_t data_full, data_empty;
};

// work unit u: data tile u % n_dt, 64-query tiles [ta, tb) of group u / n_dt
__host__ __device__ inline void unit_range(int u, int n_dt, int groups, int tiles, int& d0,
                                           int& ta, int& tb) {
  const int g = u / n_dt;
  d0 = (u % n_dt) * kTileD;
  ta = static_cast<int>(static_cast<long long>(g) * tiles / groups);
  tb = static_cast<int>(static_cast<long long>(g + 1) * tiles / groups);
}

// Consumer c takes tiles ta + c, ta + c + 3, ... of each of its CTA's
// units. KBlockSeq walks them k-block by k-block, in the order the consumer
// multiplies them, for the loads that run ahead of the products.
struct KBlockSeq {
  int u, q, kb, tb, d0;
  __device__ void enter(int c, int n_dt, int groups, int tiles, int units) {
    for (; u < units; u += gridDim.x) {         // the next unit with a tile of c's
      int ta;
      unit_range(u, n_dt, groups, tiles, d0, ta, tb);
      q = ta + c;
      if (q < tb) return;
    }
  }
  __device__ void start(int c, int n_dt, int groups, int tiles, int units) {
    u = blockIdx.x;
    kb = 0;
    enter(c, n_dt, groups, tiles, units);
  }
  __device__ void next(int c, int n_dt, int groups, int tiles, int units, int kblocks) {
    if (++kb < kblocks) return;
    kb = 0;
    q += kConsumers;
    if (q < tb) return;
    u += gridDim.x;
    enter(c, n_dt, groups, tiles, units);
  }
};

// The max of the scores over each 32-column sub-chunk of a consumer's 64 x
// 256 sums, stored at out[row, c0 + sub-chunk] for the thread's rows `row`
// and row + 8. `rowv` is the tile's row vector in shared memory (with
// Epi::kRowVector).
template <class Epi>
__device__ __forceinline__ void store_tile_max(float (&acc)[128], const float* rowv,
                                               float* __restrict__ out, int nq, int nd32,
                                               int row, int c0, int t) {
  if constexpr (Epi::kRowVector) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {     // columns 8j + 2t and 8j + 2t + 1 of both rows
      const float2 n = reinterpret_cast<const float2*>(rowv)[4 * j + t];
      acc[4 * j] = fmaf(2.f, acc[4 * j], -n.x);
      acc[4 * j + 1] = fmaf(2.f, acc[4 * j + 1], -n.y);
      acc[4 * j + 2] = fmaf(2.f, acc[4 * j + 2], -n.x);
      acc[4 * j + 3] = fmaf(2.f, acc[4 * j + 3], -n.y);
    }
  }
  float m[8][2];
#pragma unroll
  for (int s = 0; s < 8; ++s)          // 8-column groups 4s .. 4s + 3
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 16 * s + 2 * h;
      m[s][h] = fmaxf(fmaxf(fmaxf(acc[b], acc[b + 1]), fmaxf(acc[b + 4], acc[b + 5])),
                      fmaxf(fmaxf(acc[b + 8], acc[b + 9]), fmaxf(acc[b + 12], acc[b + 13])));
    }
  // reduce-scatter over the quad: bit 1 of t keeps sub-chunks 4..7 or 0..3,
  // bit 0 the upper or lower pair of those, so thread t ends with 2t, 2t + 1
  const bool hi2 = t & 2, hi1 = t & 1;
  float r[4][2], o[2][2];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float send = hi2 ? m[s][h] : m[s + 4][h], keep = hi2 ? m[s + 4][h] : m[s][h];
      r[s][h] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 2));
    }
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float send = hi1 ? r[s][h] : r[s + 2][h], keep = hi1 ? r[s + 2][h] : r[s][h];
      o[s][h] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 1));
    }
  const int c = c0 + 2 * t;            // nd32 is a multiple of 4, so c + 1 < nd32 too
#pragma unroll
  for (int h = 0; h < 2; ++h)          // never the zero rows past nd
    st_global_f2_if(out + static_cast<size_t>(row + 8 * h) * nd32 + c, Epi::finish(o[0][h]),
                    Epi::finish(o[1][h]), c < nd32 && row + 8 * h < nq);
}

template <class Epi, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
pass1_bf16_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap xmap, const Epi epi,
                 float* __restrict__ out, int nq, int nd, int kblocks, int groups) {
  using R = Ring<kResident>;
  // data_full / data_empty guard what a unit keeps: its data tile, its row vector
  constexpr bool kUnitTile = kResident || Epi::kRowVector;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);   // 1024-aligned
  const uint32_t xtile = smem_u32(smem);                           // resident data tile
  const uint32_t ring = xtile + (kResident ? kblocks * kXBlock : 0);   // [consumer][stage]
  const uint32_t rowv = ring + kConsumers * R::kStages * R::kStage;    // row vector
  const float* rowv_ptr = reinterpret_cast<const float*>(smem + (rowv - xtile));
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + (rowv - xtile) + row_bytes<Epi>());

  // warp-uniform by construction, so ptxas sees no divergence around wgmma
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool signal = lane == 0, elected = threadIdx.x % 128 == 0;
  const int n_dt = (nd + kTileD - 1) / kTileD, tiles = nq / kTileQ;
  const int units = n_dt * groups, nd32 = nd / 32;

  if (threadIdx.x == 0) {
    for (int k = 0; k < kConsumers; ++k)
      for (int s = 0; s < R::kStages; ++s) mbar_init(&bar.full[k][s], 1);
    mbar_init(&bar.data_full, 1);
    mbar_init(&bar.data_empty, 4 * kConsumers);      // lane 0 of each consumer warp
    fence_barrier_init();
  }
  __syncthreads();

  // Each consumer loads its own query tiles, R::kStages k-blocks ahead: its
  // elected thread issues the TMA into the stage the last products freed.
  const uint32_t my_ring = ring + c * R::kStages * R::kStage;
  KBlockSeq ahead;
  ahead.start(c, n_dt, groups, tiles, units);
  int load_stage = 0;
  auto load_next = [&]() {
    const bool any = ahead.u < units;
    const uint32_t st = my_ring + load_stage * R::kStage;
    mbar_expect_tx_if(&bar.full[c][load_stage], R::kStage, elected && any);
    tma_load_2d_if(st, &qmap, &bar.full[c][load_stage], ahead.kb * kFeat, ahead.q * kTileQ,
                   elected && any);
    if constexpr (!kResident)
      tma_load_2d_if(st + kQBlock, &xmap, &bar.full[c][load_stage], ahead.kb * kFeat, ahead.d0,
                     elected && any);
    if (any) ahead.next(c, n_dt, groups, tiles, units, kblocks);
    if (++load_stage == R::kStages) load_stage = 0;
  };
  for (int s = 0; s < R::kStages; ++s) load_next();

  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  int stage = 0, i = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    int d0, ta, tb;
    unit_range(u, n_dt, groups, tiles, d0, ta, tb);
    if constexpr (kUnitTile) {
      if (c == 0) {                                  // every consumer is done with the last
        if (i > 0) mbar_wait(&bar.data_empty, (i - 1) & 1);
        // the row vector up to nd: a multiple of 128 rows, so of 16 bytes
        const uint32_t vbytes = Epi::kRowVector ? 4 * min(kTileD, nd - d0) : 0;
        mbar_expect_tx_if(&bar.data_full, (kResident ? kblocks * kXBlock : 0) + vbytes, elected);
        if constexpr (kResident)
          for (int kb = 0; kb < kblocks; ++kb)
            tma_load_2d_if(xtile + kb * kXBlock, &xmap, &bar.data_full, kb * kFeat, d0, elected);
        if constexpr (Epi::kRowVector)
          bulk_load_if(rowv, epi.dn + d0, vbytes, &bar.data_full, elected);
      }
      mbar_wait(&bar.data_full, i & 1);
    }
    for (int q = ta + c; q < tb; q += kConsumers) {
      fence_regs(acc);
      wgmma_fence();                                 // the epilogue read acc
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&bar.full[c][stage], phase);
        const uint32_t st = my_ring + stage * R::kStage;
        const uint64_t da = sw128_desc(st);
        const uint64_t db = sw128_desc(kResident ? xtile + kb * kXBlock : st + kQBlock);
#pragma unroll
        for (int kk = 0; kk < kFeat / 16; ++kk)      // 32 bytes per k-step
          wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, (kb | kk) != 0);
        if constexpr (!kResident) {                  // one stage: free it for the next k-block
          wgmma_commit();
          wgmma_wait<0>();
          load_next();
        }
        if (++stage == R::kStages) { stage = 0; phase ^= 1; }
      }
      if constexpr (kResident) {
        wgmma_commit();
        wgmma_wait<0>();
        for (int kb = 0; kb < kblocks; ++kb) load_next();   // the tile's stages are free
      }
      fence_regs(acc);
      store_tile_max<Epi>(acc, rowv_ptr, out, nq, nd32, q * kTileQ + warp * 16 + g, d0 / 32, t);
    }
    if constexpr (kUnitTile) mbar_arrive_if(&bar.data_empty, signal);
  }
}

// query groups per data tile: the fewest that keep the waves of units
// within 2% of the best filling of the SMs
inline int choose_groups(int n_dt, int tiles, int sms) {
  int best = 1;
  double best_fill = 0.0;
  for (int g = 1; g <= tiles && g <= 32; ++g) {
    const long long units = static_cast<long long>(n_dt) * g;
    const long long waves = (units + sms - 1) / sms;
    const double fill = static_cast<double>(units) / static_cast<double>(waves * sms);
    if (fill > best_fill + 0.02) {
      best = g;
      best_fill = fill;
    }
  }
  return best;
}

template <class Epi, bool kResident>
int launch_wgmma(const CUtensorMap& qmap, const CUtensorMap& xmap, const Epi& epi, float* out,
                 int nq, int nd, int kblocks, int groups, int grid, cudaStream_t stream) {
  using R = Ring<kResident>;
  const int bytes = 1024 + (kResident ? kblocks * kXBlock : 0) +
                    kConsumers * R::kStages * R::kStage + row_bytes<Epi>() +
                    static_cast<int>(sizeof(Barriers));
  auto kernel = pass1_bf16_wgmma<Epi, kResident>;
  // above the 48 KB default; set on every launch, since it holds per device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, stream>>>(qmap, xmap, epi, out, nq, nd, kblocks, groups);
  return static_cast<int>(cudaGetLastError());
}

// q (nq, dp) and x (nd, dp) bf16, out (nq, nd / 32) fp32, on `stream`; the
// caller has checked the shapes. Returns cudaGetLastError(), or 10000 + the
// CUresult of a failed tensor-map encode.
template <class Epi>
int launch(const void* q, const void* x, const Epi& epi, float* out, int nq, int nd, int dp,
           cudaStream_t stream) {
  if (nq == 0 || nd == 0) return 0;
  CUtensorMap qmap, xmap;
  int err = encode_bf16_rows(&qmap, q, nq, dp, kTileQ);
  if (err == 0) err = encode_bf16_rows(&xmap, x, nd, dp, kTileD);
  if (err != 0) return kEncodeError + err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int kblocks = dp / kFeat;
  const int n_dt = (nd + kTileD - 1) / kTileD, tiles = nq / kTileQ;
  const int groups = choose_groups(n_dt, tiles, sms);
  const long long units = static_cast<long long>(n_dt) * groups;
  const int grid = static_cast<int>(units < sms ? units : sms);
  if (kblocks <= kResidentKB)
    return launch_wgmma<Epi, true>(qmap, xmap, epi, out, nq, nd, kblocks, groups, grid, stream);
  return launch_wgmma<Epi, false>(qmap, xmap, epi, out, nq, nd, kblocks, groups, grid, stream);
}

}  // namespace wgmma_pass1
