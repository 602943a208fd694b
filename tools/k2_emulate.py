#!/usr/bin/env python3
"""K2's warp algorithm (csrc/topk_rows.cu) emulated lane by lane in numpy.

    python3 tools/k2_emulate.py [--seed 0] [--head 20]

Runs on the CPU, no card needed: a model of the kernel's selection for
checking a change to its algorithm before it goes to the card. Each warp
operation (ballot, __shfl_up, the bitonic sort of the lane maxima) is an
operation on a 32-lane numpy array, with the kernel's head of --head steps
of 32 columns (TOPK_ROWS_HEAD) and its two list slots for k > 32. Holds the
model against a stable descending sort, values and columns, on adversarial
rows (ties, all equal, all -inf, fewer finite entries than k, ascending,
descending, merge rows) at widths 1-900 and k = 1-64, and prints the number
of rows, the mismatches, and the insertions a random row of 3136 and of
640 columns takes at k = 20. Exits non-zero on a mismatch.
"""
import argparse
import sys

import numpy as np

INT_MAX = 2**31 - 1
LANES = np.arange(32)


def shfl_up(a):
    out = a.copy()
    out[1:] = a[:-1]
    return out


def kth_value(ev, k):
    return (ev[1] if len(ev) == 2 and k > 32 else ev[0])[(k - 1) & 31]


def warp_kth_largest(m, k):
    """The kernel's bitonic sort of one value a lane; the k-th largest."""
    v = m.copy()
    size = 2
    while size <= 32:
        stride = size >> 1
        while stride > 0:
            o = v[LANES ^ stride]
            keep_max = ((LANES & stride) == 0) == ((LANES & size) == 0)
            v = np.where(keep_max, np.maximum(v, o), np.minimum(v, o))
            stride >>= 1
        size <<= 1
    return v[k - 1]


def insert(ev, ec, v, col, filled):
    pos = min(sum(int(np.sum(e >= v)) for e in ev), filled)
    uv, uc = [shfl_up(ev[0])], [shfl_up(ec[0])]
    if len(ev) == 2:                        # slot 1's lane 0 takes slot 0's lane 31
        src = (LANES + 31) & 31
        uv.append(np.where(LANES == 31, ev[0], ev[1])[src])
        uc.append(np.where(LANES == 31, ec[0], ec[1])[src])
    for s in range(len(ev)):
        p = 32 * s + LANES
        ev[s] = np.where(p > pos, uv[s], np.where(p == pos, np.float32(v), ev[s]))
        ev[s] = ev[s].astype(np.float32)
        ec[s] = np.where(p > pos, uc[s], np.where(p == pos, col, ec[s]))


def load(xr, base):
    c = base + LANES
    return np.where(c < len(xr), xr[np.minimum(c, len(xr) - 1)], -np.inf).astype(np.float32)


def topk_row(xr, k, head_steps, steps=8):
    """(values, columns, insertions) of the model on one row."""
    w = len(xr)
    slots = 1 if k <= 32 else 2
    head = [load(xr, 32 * j) for j in range(head_steps)]
    floor_v = warp_kth_largest(np.max(head, axis=0), k) if slots == 1 else -np.inf
    ev = [np.full(32, -np.inf, np.float32) for _ in range(slots)]
    ec = [np.full(32, INT_MAX) for _ in range(slots)]
    thr, filled, inserted = -np.inf, 0, 0
    for j, xv in enumerate(head):
        fit = (32 * j + LANES < w) & (xv >= floor_v)
        m = fit & ((filled < k) | (xv > thr))
        while m.any():
            src = int(np.argmax(m))
            insert(ev, ec, xv[src], 32 * j + src, filled)
            filled += 1
            inserted += 1
            thr = kth_value(ev, k)
            m = (LANES > src) & fit & ((filled < k) | (xv > thr))
    for base in range(32 * head_steps, w, 32):
        xv = load(xr, base)
        m = xv > thr
        while m.any():
            src = int(np.argmax(m))
            insert(ev, ec, xv[src], base + src, 32 * slots)
            inserted += 1
            thr = kth_value(ev, k)
            m = (LANES > src) & (xv > thr)
    return np.concatenate(ev)[:k], np.concatenate(ec)[:k], inserted


def rows(rng):
    for w in (1, 2, 5, 20, 31, 32, 33, 40, 63, 64, 65, 100, 129, 640, 641, 700, 900):
        for k in (1, 2, 13, 20, 32, 33, 40, 64):
            if k > w:
                continue
            few = np.full(w, -np.inf, np.float32)
            few[rng.integers(0, w, 3)] = rng.normal(size=3)
            mix = rng.integers(0, 4, w).astype(np.float32)
            mix[mix == 3] = -np.inf
            yield rng.normal(size=w).astype(np.float32), k
            yield rng.integers(0, 3, w).astype(np.float32), k
            yield np.ones(w, np.float32), k
            yield np.full(w, -np.inf, np.float32), k
            yield np.arange(w, dtype=np.float32), k
            yield -np.arange(w, dtype=np.float32), k
            yield few, k
            yield mix, k
    for k in (20, 64):                      # merge rows: the running best, then a tile
        tile = rng.normal(size=800).astype(np.float32)
        best = np.sort(rng.normal(size=k).astype(np.float32) + 2)[::-1]
        tile[5] = best[-1]
        yield np.concatenate([best, tile]), k
        yield np.concatenate([np.full(k, -np.inf, np.float32), tile]), k


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--head", type=int, default=20, help="head steps of 32 columns (>= 2)")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    n = bad = 0
    for xr, k in rows(rng):
        v, i, _ = topk_row(xr, k, args.head)
        order = np.argsort(-xr, kind="stable")[:k]
        n += 1
        if not (np.array_equal(v, xr[order]) and np.array_equal(i, order)):
            bad += 1
            print(f"mismatch: w={len(xr)} k={k} got {i[:8]} want {order[:8]}")
    counts = {w: topk_row(rng.normal(size=w).astype(np.float32), 20, args.head)[2]
              for w in (3136, 640)}
    print(f"{n} rows, {bad} mismatches; insertions of a random row at k = 20: "
          f"w = 3136: {counts[3136]}, w = 640: {counts[640]}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
