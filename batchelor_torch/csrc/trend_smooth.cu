// Tricube-weighted local linear smoother on the card, in float64: K6.
//
// Replaces no TPU kernel: the JAX package fits the mean-variance trend in
// host numpy, and so does the port on host arrays. This is the port's own
// kernel for the smoother of that fit (correct/diagnostics.py's
// _sorted_local_linear, the plain version) when the moments lie on the
// card, so that they never travel to the host.
//
// Contract: n points (xs, ys), fp64, sorted by xs ascending (finite), and a
// window 2 <= W <= n. For each of nq queries (fp64, any value), as numpy
// computes it: pos = searchsorted(xs, q, side="left") (NaN above every
// number), lo = clip(pos - W/2, 0, n - W), the window xs[lo .. lo+W),
// h = max(max |x - q| over it, 1e-12), tricube weights
// w = (1 - min(|x - q| / h, 1)^3)^3, then sw = sum w, xm = sum w x / sw',
// ym = sum w y / sw' (sw' = max(sw, 1e-300)), den = sum w dx^2,
// num = sum w dx (y - ym) (dx = x - xm), slope = num / den where
// den > 1e-12 and 0 elsewhere, and out = ym + slope (q - xm) where sw > 0,
// else the window's mean of y. NaN propagates through h and the weights
// as through numpy's maximum and minimum, so a non-finite query gets its
// window's mean. Sums are taken in another order than numpy's: the result
// agrees to fp64 rounding.
//
// Bound on this card: fp64 arithmetic, two passes over W points a query,
// 24 flops a point (an FMA as two), at 33.5 TFLOP/s; each pass also
// divides once a point. The points (16 n bytes) stay in L1 and L2.
//
// Design: one warp a query, eight a CTA. The wrapper sorts the queries, so
// the eight warps of a CTA, and neighbouring CTAs, read overlapping
// windows, which stay in L1; out[order[i]] puts each result back in place.
// Every lane finds the window by the same binary search; h is the larger
// distance at the window's two ends, since |x - q| is monotone on each
// side of q in sorted x. The lanes stride the window (coalesced reads) for
// sw, sum w x, sum w y and sum y, reduce them by warp shuffles, then stride
// it again, recomputing each weight, for den and num. No (queries x window)
// array exists anywhere.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// numpy's searchsorted(xs, q, side="left"): the first i with xs[i] >= q,
// NaN sorting above every number.
__device__ __forceinline__ int search_left(const double* __restrict__ xs, int n, double q) {
  if (q != q) return n;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(xs + mid) < q)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The tricube weight of x at q with bandwidth h; a NaN ratio stays NaN, as
// numpy's minimum keeps it.
__device__ __forceinline__ double tricube(double x, double q, double h) {
  double t = fabs(x - q) / h;
  t = t > 1.0 ? 1.0 : t;
  const double u = 1.0 - t * t * t;
  return u * u * u;
}

__global__ void __launch_bounds__(kThreads)
    trend_smooth_kernel(const double* __restrict__ xs, const double* __restrict__ ys, int n,
                        int window, const double* __restrict__ q,
                        const int64_t* __restrict__ order, int nq, double* __restrict__ out) {
  const int query = blockIdx.x * kWarps + static_cast<int>(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (query >= nq) return;  // the whole warp leaves together
  const double qi = q[query];
  int lo = search_left(xs, n, qi) - window / 2;
  lo = min(max(lo, 0), n - window);
  const double* __restrict__ xw = xs + lo;
  const double* __restrict__ yw = ys + lo;

  const double d0 = fabs(__ldg(xw) - qi), d1 = fabs(__ldg(xw + window - 1) - qi);
  double h = d1 > d0 ? d1 : d0;  // both NaN for a NaN query
  h = h < 1e-12 ? 1e-12 : h;     // numpy's maximum: NaN stays

  double sw = 0.0, swx = 0.0, swy = 0.0, sy = 0.0;
  for (int i = lane; i < window; i += 32) {
    const double x = __ldg(xw + i), y = __ldg(yw + i);
    const double w = tricube(x, qi, h);
    sw += w;
    swx += w * x;
    swy += w * y;
    sy += y;
  }
  sw = warp_sum(sw);
  swx = warp_sum(swx);
  swy = warp_sum(swy);
  sy = warp_sum(sy);
  const double sw_safe = sw < 1e-300 ? 1e-300 : sw;
  const double xm = swx / sw_safe, ym = swy / sw_safe;

  double den = 0.0, num = 0.0;
  for (int i = lane; i < window; i += 32) {
    const double x = __ldg(xw + i), y = __ldg(yw + i);
    const double w = tricube(x, qi, h);
    const double dx = x - xm;
    den += w * (dx * dx);
    num += (w * dx) * (y - ym);
  }
  den = warp_sum(den);
  num = warp_sum(num);
  if (lane == 0) {
    const double slope = den > 1e-12 ? num / den : 0.0;
    const double fit = ym + slope * (qi - xm);
    out[order[query]] = sw > 0.0 ? fit : sy / window;
  }
}

}  // namespace

// Launch on `stream`. xs, ys (n) fp64 sorted by xs; q (nq) fp64 sorted
// ascending, order (nq) int64 the query's place in out (nq) fp64.
// Requires 2 <= window <= n. Returns cudaGetLastError().
extern "C" int trend_smooth_launch(const double* xs, const double* ys, int n, int window,
                                   const double* q, const int64_t* order, int nq, double* out,
                                   void* stream) {
  if (nq == 0) return 0;
  if (window < 2 || window > n || nq < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (nq + kWarps - 1) / kWarps;
  trend_smooth_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, ys, n, window, q, order, nq, out);
  return static_cast<int>(cudaGetLastError());
}
