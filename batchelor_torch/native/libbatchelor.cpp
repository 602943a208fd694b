// Native host-side runtime for batchelor_tpu.
//
// The reference delegates its host-side heavy lifting to native code in
// dependencies (BiocNeighbors' C++ kNN intersection, igraph's C components,
// beachmat's C++ matrix access — SURVEY.md §2.2). This library is the
// TPU-native build's equivalent: the device compute path is JAX/XLA/Pallas,
// and the host runtime around it (pair-list intersection, graph components,
// CSR block streaming for the data loader) is C++.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread (see bindings.py).
// All functions are extern "C" for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : static_cast<int>(n);
}

template <typename F>
void parallel_for(int64_t n, F&& fn, int64_t grain = 1024) {
  int nt = hardware_threads();
  if (n < grain * 2 || nt <= 1) {
    fn(0, n);
    return;
  }
  nt = static_cast<int>(std::min<int64_t>(nt, (n + grain - 1) / grain));
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Mutual-NN intersection (reference src/find_mutual_nns.cpp:7-41 semantics,
// 0-based): l2r[n1 x k2] holds each left cell's neighbours in right (by
// distance rank); r2l[n2 x k1] each right cell's neighbours in left. A pair
// (i, j) is mutual iff j in l2r[i] and i in r2l[j]. Pairs are emitted
// ordered by left cell then neighbour rank. Returns the pair count;
// writes at most max_pairs pairs.
int64_t bt_mutual_nn(const int32_t* l2r, int64_t n1, int64_t k2,
                     const int32_t* r2l, int64_t n2, int64_t k1,
                     int32_t* out_first, int32_t* out_second,
                     int64_t max_pairs) {
  // sort each right row for binary search
  std::vector<int32_t> sorted(static_cast<size_t>(n2) * k1);
  parallel_for(n2, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const int32_t* row = r2l + r * k1;
      int32_t* dst = sorted.data() + r * k1;
      std::copy(row, row + k1, dst);
      std::sort(dst, dst + k1);
    }
  });

  // per-left-row pair counts, then prefix sums for parallel emission
  std::vector<int64_t> counts(n1);
  parallel_for(n1, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t c = 0;
      const int32_t* row = l2r + i * k2;
      for (int64_t p = 0; p < k2; ++p) {
        const int32_t j = row[p];
        const int32_t* s = sorted.data() + static_cast<int64_t>(j) * k1;
        if (std::binary_search(s, s + k1, static_cast<int32_t>(i))) ++c;
      }
      counts[i] = c;
    }
  });
  std::vector<int64_t> offsets(n1 + 1, 0);
  std::partial_sum(counts.begin(), counts.end(), offsets.begin() + 1);
  int64_t total = offsets[n1];
  if (out_first == nullptr || out_second == nullptr) return total;

  parallel_for(n1, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t pos = offsets[i];
      if (pos >= max_pairs) continue;
      const int32_t* row = l2r + i * k2;
      for (int64_t p = 0; p < k2 && pos < max_pairs; ++p) {
        const int32_t j = row[p];
        const int32_t* s = sorted.data() + static_cast<int64_t>(j) * k1;
        if (std::binary_search(s, s + k1, static_cast<int32_t>(i))) {
          out_first[pos] = static_cast<int32_t>(i);
          out_second[pos] = j;
          ++pos;
        }
      }
    }
  });
  return std::min<int64_t>(total, max_pairs);
}

// Connected components by union-find with path halving (igraph replacement
// for clusterMNN meta-clusters, reference R/clusterMNN.R:162-165).
// labels out: component ids in first-appearance order.
void bt_union_find(int64_t n, const int64_t* edges, int64_t n_edges,
                   int64_t* labels) {
  std::vector<int64_t> parent(n);
  std::iota(parent.begin(), parent.end(), 0);
  auto find = [&](int64_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  };
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ru = find(edges[2 * e]);
    int64_t rv = find(edges[2 * e + 1]);
    if (ru != rv) parent[std::max(ru, rv)] = std::min(ru, rv);
  }
  std::vector<int64_t> remap(n, -1);
  int64_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = find(i);
    if (remap[r] < 0) remap[r] = next++;
    labels[i] = remap[r];
  }
}

// CSR block densification: rows [row_start, row_end) of a CSR matrix into a
// dense row-major block (the beachmat-style block access used to stream
// cell blocks to the device). Multithreaded over rows.
void bt_csr_densify(const float* data, const int32_t* indices,
                    const int64_t* indptr, int64_t row_start, int64_t row_end,
                    int64_t ncols, float* out) {
  int64_t nrows = row_end - row_start;
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(nrows) * ncols);
  parallel_for(nrows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t row = row_start + r;
      float* dst = out + r * ncols;
      for (int64_t p = indptr[row]; p < indptr[row + 1]; ++p) {
        dst[indices[p]] = data[p];
      }
    }
  }, 64);
}

// Per-row sums of a CSR matrix (library sizes; scuttle's
// librarySizeFactors substrate).
void bt_csr_row_sums(const float* data, const int64_t* indptr, int64_t nrows,
                     double* out) {
  parallel_for(nrows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      double s = 0;
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) s += data[p];
      out[r] = s;
    }
  }, 256);
}

// Column-subset a CSR matrix. col_map: ncols entries, new column id or -1 to
// drop. Two-phase: pass out_data=null to get the nnz; then fill.
int64_t bt_csr_select_columns(const float* data, const int32_t* indices,
                              const int64_t* indptr, int64_t nrows,
                              const int32_t* col_map, float* out_data,
                              int32_t* out_indices, int64_t* out_indptr) {
  if (out_data == nullptr) {
    std::atomic<int64_t> total{0};
    parallel_for(nrows, [&](int64_t lo, int64_t hi) {
      int64_t local = 0;
      for (int64_t r = lo; r < hi; ++r)
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p)
          if (col_map[indices[p]] >= 0) ++local;
      total += local;
    }, 256);
    return total.load();
  }
  int64_t pos = 0;
  out_indptr[0] = 0;
  for (int64_t r = 0; r < nrows; ++r) {
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      int32_t nc = col_map[indices[p]];
      if (nc >= 0) {
        out_data[pos] = data[p];
        out_indices[pos] = nc;
        ++pos;
      }
    }
    out_indptr[r + 1] = pos;
  }
  return pos;
}

// Sparse log-normalize + optional cosine normalization, in place over the
// value buffer: v -> log(v/sf_row + 1)/log(base), then per-row division by
// max(l2, 1e-8) (cosineNorm zero guard, reference R/cosineNorm.R:80).
// Zeros stay zero, so only the nnz values are touched — the threaded
// replacement for the host-numpy loop in correct/outofcore.py (the
// reference's equivalent transforms are compiled dgCMatrix methods).
void bt_csr_lognorm_cosine(const float* data, const int64_t* indptr,
                           int64_t nrows, const float* sf, double log_base,
                           int cos_norm, float* out) {
  const double inv_log = 1.0 / std::log(log_base);
  parallel_for(nrows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const double s = sf[r];
      double sq = 0.0;
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const double v = std::log1p(static_cast<double>(data[p]) / s) * inv_log;
        out[p] = static_cast<float>(v);
        sq += v * v;
      }
      if (cos_norm) {
        const double l2 = std::max(std::sqrt(sq), 1e-8);
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
          out[p] = static_cast<float>(static_cast<double>(out[p]) / l2);
        }
      }
    }
  }, 64);
}

// Per-gene sums of unlogged values: sum over nnz of (base^v - 1) into
// out_sums[ncols] (the count-space per-gene averages feeding
// rescaleBatches, reference R/rescaleBatches.R:102-148). Thread-local
// accumulators merged at the end.
void bt_csr_unlog_colsums(const float* data, const int32_t* indices,
                          int64_t nnz, int64_t ncols, double log_base,
                          double* out_sums) {
  const double lb = std::log(log_base);
  int nt = hardware_threads();
  if (nnz < 4096 || nt <= 1) {
    std::fill(out_sums, out_sums + ncols, 0.0);
    for (int64_t p = 0; p < nnz; ++p)
      out_sums[indices[p]] += std::expm1(static_cast<double>(data[p]) * lb);
    return;
  }
  nt = static_cast<int>(std::min<int64_t>(nt, nnz / 2048));
  std::vector<std::vector<double>> local(nt, std::vector<double>(ncols, 0.0));
  std::vector<std::thread> threads;
  int64_t chunk = (nnz + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, nnz);
    if (lo >= hi) break;
    threads.emplace_back([&, t, lo, hi] {
      double* acc = local[t].data();
      for (int64_t p = lo; p < hi; ++p)
        acc[indices[p]] += std::expm1(static_cast<double>(data[p]) * lb);
    });
  }
  for (auto& th : threads) th.join();
  std::fill(out_sums, out_sums + ncols, 0.0);
  for (auto& acc : local)
    for (int64_t c = 0; c < ncols; ++c) out_sums[c] += acc[c];
}

// Per-gene rescale in log space: v -> log1p((base^v - 1) * scale[gene]) /
// log(base) (the .unlog -> scale -> .relog sequence of
// reference R/rescaleBatches.R:150-182, zeros preserved).
void bt_csr_rescale(const float* data, const int32_t* indices, int64_t nnz,
                    const double* scale, double log_base, float* out) {
  const double lb = std::log(log_base);
  const double inv_lb = 1.0 / lb;
  parallel_for(nnz, [&](int64_t lo, int64_t hi) {
    for (int64_t p = lo; p < hi; ++p) {
      const double u = std::expm1(static_cast<double>(data[p]) * lb);
      out[p] = static_cast<float>(std::log1p(u * scale[indices[p]]) * inv_lb);
    }
  }, 4096);
}

// Per-gene streaming statistics for the quickCorrect prep stages, O(nnz)
// on the host: sums of v/sf (scuttle::calculateAverage substrate), of
// log(v/sf + 1)/log(base) (logNormCounts means) and its square (variance
// moments), exploiting that pseudo_count=1 keeps zeros at zero so only
// nnz entries contribute (reference R/multiBatchNorm.R:226-234 +
// scran::modelGeneVar's per-gene moments). Thread-local (3 x ncols)
// accumulators over row ranges, merged at the end.
void bt_csr_gene_stats(const float* data, const int32_t* indices,
                       const int64_t* indptr, int64_t nrows, int64_t ncols,
                       const float* sf, double log_base, double* out_avg,
                       double* out_s1, double* out_s2) {
  const double inv_log = 1.0 / std::log(log_base);
  int nt = hardware_threads();
  nt = static_cast<int>(
      std::min<int64_t>(nt, std::max<int64_t>(nrows / 1024, 1)));
  std::vector<std::vector<double>> local(
      nt, std::vector<double>(3 * ncols, 0.0));
  std::vector<std::thread> threads;
  int64_t chunk = (nrows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, nrows);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi, t] {
      double* acc = local[t].data();
      for (int64_t r = lo; r < hi; ++r) {
        const double s = sf[r];
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
          const double norm = static_cast<double>(data[p]) / s;
          const double lg = std::log1p(norm) * inv_log;
          const int64_t c = indices[p];
          acc[c] += norm;
          acc[ncols + c] += lg;
          acc[2 * ncols + c] += lg * lg;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  std::fill(out_avg, out_avg + ncols, 0.0);
  std::fill(out_s1, out_s1 + ncols, 0.0);
  std::fill(out_s2, out_s2 + ncols, 0.0);
  for (auto& acc : local) {
    for (int64_t c = 0; c < ncols; ++c) {
      out_avg[c] += acc[c];
      out_s1[c] += acc[ncols + c];
      out_s2[c] += acc[2 * ncols + c];
    }
  }
}

int bt_version() { return 3; }

}  // extern "C"
