#!/usr/bin/env python3
"""K3's algorithm (csrc/rescore_chunks.cu) emulated step by step in numpy.

    python3 tools/k3_emulate.py [--seed 0] [--slots 64] [--count-slots 8192]

Runs on the CPU, no card needed: a model of the kernel's sorted path
(taken from RESCORE_SORT_MIN = 2 slots a sub-chunk; below it one warp
rescores a query) for checking a change to its algorithm
before it goes to the card. It follows the
kernel's three steps: the bucket counts, CTA by CTA in shared memory and
then into the global counts (the atomics' orders drawn at random), with
each slot's rank and the scan into offsets; the scatter of the (slot,
sub-chunk) pairs into sorted order; and the
rescore of --slots (P) sorted slots per work item, which finds the
segments from the per-warp start masks as the kernel does, stages data3[c]
and the segment's query rows into the kernel's swizzled feature-major
shared-memory arrays by the kernel's own index arithmetic, reads them back
by the compute threads' addresses, and runs each output's sum as one fp32
chain over the features in order. Each chain step is rounded once in fp64
and then to fp32, which is fmaf's single rounding but for a rare tie in
the last bit. (The threads' QT x 4 tiles only share these chains out.)
It counts the writes of every output row.

As a script it holds the model against a float64 rescore on skewed inputs
(a hub bucket cut into several items with masked rows, singleton and empty
buckets, repeated ids within a row, ids out of range, d = 1-300) and
prints, per case, the bucket statistics, the segments per item and the
worst error as a share of the row's max |score|. Exits non-zero when an
output row is written other than once or an error exceeds 2^-20.
"""
import argparse
import sys

import numpy as np

SUB = 32                # data rows per sub-chunk
KT = 64                 # features staged at most (RESCORE_FEATURES)
P_DEFAULT = 64          # RESCORE_SLOTS
COUNT_SLOTS = 8192      # slots a CTA of bucket_count_kernel counts
HIST_MAX = 8192         # sub-chunks counted in shared memory


def bucket(top_sub, c32, rng, count_slots=COUNT_SLOTS):
    """Steps 1 and 2: (sorted (slot, c) pairs of the in-range slots, offsets
    with the in-range total last, ranks with -1 for an id out of range).
    CTAs of count_slots slots count in shared memory (arrival order at
    random), then add each count to the global one in a random CTA order,
    which gives the CTA's base in the bucket; above HIST_MAX sub-chunks
    every slot counts globally, in a random order."""
    flat = np.asarray(top_sub, np.int64).reshape(-1)
    n_slots = flat.size
    valid = (flat >= 0) & (flat < c32)
    rank = np.full(n_slots, -1, np.int64)
    counts = np.zeros(c32, np.int64)
    ctas = [np.arange(a, min(a + count_slots, n_slots)) for a in range(0, n_slots, count_slots)]
    if c32 > HIST_MAX:
        ctas = [np.arange(n_slots)]                 # one global count in arrival order
    local = []
    for slots in ctas:
        arrival = rng.permutation(slots)
        arrival = arrival[valid[arrival]]
        by_bucket = arrival[np.argsort(flat[arrival], kind="stable")]
        sizes = np.bincount(flat[by_bucket], minlength=c32)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        rank[by_bucket] = np.arange(by_bucket.size) - np.repeat(starts, sizes)
        local.append((slots, sizes))
    for t in rng.permutation(len(local)):           # the CTAs' global atomics
        slots, sizes = local[t]
        base = counts.copy()
        counts += sizes
        ok = slots[valid[slots]]
        rank[ok] += base[flat[ok]]
    offsets = np.concatenate([[0], np.cumsum(counts)])      # exclusive scan, total last
    sorted_pairs = np.full((int(offsets[-1]), 2), -1, np.int64)
    ok = rank >= 0
    pos = offsets[flat[ok]] + rank[ok]
    assert np.array_equal(np.sort(pos), np.arange(pos.size)), "ranks collide"
    sorted_pairs[pos, 0] = np.nonzero(ok)[0]
    sorted_pairs[pos, 1] = flat[ok]
    return sorted_pairs, offsets, rank


def segment_starts(cs, n, p):
    """The per-warp ballot masks of segment starts, walked as next_start does."""
    flags = np.zeros(p, bool)
    flags[:n] = np.concatenate([[True], cs[1:n] != cs[:n - 1]])
    masks = [int(np.sum(flags[32 * w:32 * w + 32].astype(np.int64) << np.arange(32)))
             for w in range(p // 32)]

    def next_start(pos):
        for w in range(pos >> 5, p // 32):
            m = masks[w] & ((0xFFFFFFFF << (pos & 31)) & 0xFFFFFFFF if w == pos >> 5
                            else 0xFFFFFFFF)
            if m:
                return min(n, 32 * w + (m & -m).bit_length() - 1)
        return n

    bounds, s0 = [], 0
    while s0 < n:
        s1 = next_start(s0 + 1)
        bounds.append((s0, s1))
        s0 = s1
    return bounds


def stage(src_rows, k0, kn, groups, row_len):
    """The kernel's staging loops: a warp copies 4 rows (of data3[c], or
    query rows) x 8 features at once into a flat feature-major array of
    row_len floats a feature, the 4-row group g of feature k at group
    g ^ (k & 7); features zero padded to a multiple of 8, rows past
    src_rows zero. Returns the array and the features staged."""
    kc = (kn + 7) & ~7
    smem = np.full(KT * row_len, np.nan, np.float32)
    g, sb, skl, o = np.meshgrid(np.arange(groups), np.arange(4), np.arange(8),
                                np.arange(kc // 8), indexing="ij")
    row, k = 4 * g + sb, 8 * o + skl
    val = np.zeros(row.shape, np.float32)
    take = (k < kn) & (row < src_rows.shape[0])
    val[take] = src_rows[row[take], k0 + k[take]]
    smem[(k * row_len + 4 * (g ^ skl) + sb).ravel()] = val.ravel()
    return smem, kc


def read_back(smem, kc, groups, row_len):
    """The compute threads' 16-byte reads, feature by feature: (kc,
    4 * groups) values, feature k of row 4t + u at k * row_len + 4 (t ^ (k & 7)) + u."""
    k = np.arange(kc)[:, None, None]
    t = np.arange(groups)[None, :, None]
    u = np.arange(4)[None, None, :]
    return smem[k * row_len + 4 * (t ^ (k & 7)) + u].reshape(kc, 4 * groups)


def rescore(q, data3, dn2, top_sub, p=P_DEFAULT, rng=None, count_slots=COUNT_SLOTS):
    """The kernel's output (nq, ks * 32), the write count of every output
    row, and the segments of every work item."""
    rng = rng if rng is not None else np.random.default_rng(0)
    q = np.asarray(q, np.float32)
    data3 = np.asarray(data3, np.float32)
    dn2 = np.asarray(dn2, np.float32)
    nq, d = q.shape
    c32 = data3.shape[0]
    ks = top_sub.shape[1]
    n_slots = nq * ks
    out = np.full((n_slots, SUB), np.nan, np.float32)     # never-written rows stay NaN
    writes = np.zeros(n_slots, np.int64)
    sorted_pairs, offsets, rank = bucket(top_sub, c32, rng, count_slots)
    bad = rank < 0
    out[bad] = np.nan                                     # the scatter's NaN rows
    writes[bad] += 1
    n_valid = int(offsets[-1])
    segments = []
    for t in range((n_slots + p - 1) // p):
        a = t * p
        if a >= n_valid:
            continue
        n = min(p, n_valid - a)
        slots = sorted_pairs[a:a + n, 0]
        cs = sorted_pairs[a:a + n, 1]
        qrow = slots // ks
        bounds = segment_starts(cs, n, p)
        segments.append(len(bounds))
        for s0, s1 in bounds:
            ns, c = s1 - s0, int(cs[s0])
            acc = np.zeros((ns, SUB), np.float32)
            for k0 in range(0, d, KT):
                kn = min(KT, d - k0)
                xs, kc = stage(data3[c], k0, kn, SUB // 4, SUB)
                qs, _ = stage(q[qrow[s0:s1]], k0, kn, (ns + 3) // 4, p)
                xk = read_back(xs, kc, SUB // 4, SUB)            # (features, 32)
                qk = read_back(qs, kc, p // 4, p)[:, :ns]        # (features, ns)
                for k in range(kc):
                    acc = (acc.astype(np.float64)
                           + qk[k].astype(np.float64)[:, None] * xk[k].astype(np.float64)
                           ).astype(np.float32)
            out[slots[s0:s1]] = np.float32(2.0) * acc - dn2[c]
            writes[slots[s0:s1]] += 1
    return out.reshape(nq, ks * SUB), writes, np.array(segments, np.int64)


def bucket_stats(top_sub, c32):
    """Slots per sub-chunk over all c32 sub-chunks (empty ones included)."""
    flat = np.asarray(top_sub).reshape(-1)
    sizes = np.bincount(flat[(flat >= 0) & (flat < c32)], minlength=c32)
    return {"unique": int((sizes > 0).sum()), "median": float(np.median(sizes)),
            "p99": float(np.percentile(sizes, 99)), "max": int(sizes.max())}


def skewed_case(rng, nq, ks, c32, d, hub=1, masked=(3, 9)):
    """Every query selects the hub first; the other ids spread over c32,
    some repeated within a row; dn2 masks rows of the hub."""
    q = rng.normal(size=(nq, d)).astype(np.float32)
    data3 = rng.normal(size=(c32, SUB, d)).astype(np.float32)
    dn2 = (data3.astype(np.float64) ** 2).sum(2).astype(np.float32)
    dn2[hub, masked[0]:masked[1]] = np.inf
    top_sub = rng.integers(0, c32, size=(nq, ks))
    top_sub[:, 0] = hub
    if ks > 2:
        top_sub[::5, 2] = top_sub[::5, 1]                 # repeated ids within a row
    return q, data3, dn2, top_sub


def check(q, data3, dn2, top_sub, out, writes):
    """(worst |error| / row max, every row written once, -inf exactly where masked)."""
    ids = np.clip(top_sub, 0, data3.shape[0] - 1)
    want = (2.0 * np.einsum("qksd,qd->qks", data3.astype(np.float64)[ids], q.astype(np.float64))
            - dn2.astype(np.float64)[ids]).reshape(out.shape)
    bad = np.repeat((top_sub < 0) | (top_sub >= data3.shape[0]), SUB, axis=1)
    want[bad] = np.nan
    inf = np.isinf(want)
    same_inf = np.array_equal(inf, np.isinf(out)) and bool((out[inf] < 0).all())
    same_nan = np.array_equal(np.isnan(want), np.isnan(out))
    fin = ~inf & ~bad
    scale = np.where(fin, np.abs(want), 0.0).max(axis=1, keepdims=True)
    err = np.where(fin, np.abs(out.astype(np.float64) - np.where(fin, want, 0.0)), 0.0)
    worst = float((err / np.maximum(scale, 1e-300)).max())
    return worst, bool((writes == 1).all()), same_inf and same_nan


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=P_DEFAULT, help="P, a multiple of 32")
    ap.add_argument("--count-slots", type=int, default=COUNT_SLOTS,
                    help="slots a counting CTA takes (small values split the count)")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    cases = [(300, 6, 900, 50), (300, 6, 900, 7), (70, 4, 40, 129), (50, 3, 500, 300),
             (1, 1, 5, 1), (9, 1, 2, 64), (200, 20, 64, 16), (100, 4, HIST_MAX + 1, 8)]
    failed = 0
    for nq, ks, c32, d in cases:
        q, data3, dn2, top_sub = skewed_case(rng, nq, ks, c32, d)
        if nq > 50:
            top_sub[7, 3] = c32                           # out of range: a NaN row
        out, writes, segs = rescore(q, data3, dn2, top_sub, args.slots, rng, args.count_slots)
        worst, once, same = check(q, data3, dn2, top_sub, out, writes)
        ok = once and same and worst <= 2.0 ** -20
        failed += not ok
        print(f"nq={nq} ks={ks} c32={c32} d={d}: buckets {bucket_stats(top_sub, c32)}, "
              f"items {segs.size}, segments per item max {segs.max()} mean {segs.mean():.2f}; "
              f"written once {once}, same -inf/NaN {same}, worst {worst:.3g} of max|s|"
              f"{'' if ok else '  FAIL'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
