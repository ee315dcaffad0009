"""Brute-force float64 oracles for all four problem variants.

Ground truth for parity tests, equivalent to the reference's CsvTester
(CsvTester.java:27-141) plus the DTW cases CsvTester leaves unimplemented
(CsvTester.java:115-117); the DTW semantics follow the UCR-style banded DP the
engines use for verification (DtwUtils.java:269-337, QueryEngineDtw.java:385-452).

All offsets are 0-based window start positions.  Distances are square-rooted, and an
offset is an answer iff distance^2 <= epsilon^2 (matching the engines' comparisons).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def sliding_mean_std(data: np.ndarray, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Population mean/std of every length-w window, float64 cumsum based."""
    c1 = np.concatenate(([0.0], np.cumsum(data, dtype=np.float64)))
    c2 = np.concatenate(([0.0], np.cumsum(data.astype(np.float64) ** 2)))
    s1 = c1[w:] - c1[:-w]
    s2 = c2[w:] - c2[:-w]
    mean = s1 / w
    var = np.maximum(s2 / w - mean * mean, 0.0)
    return mean, np.sqrt(var)


def rsm_ed(data: np.ndarray, query: np.ndarray, epsilon: float) -> Tuple[np.ndarray, np.ndarray]:
    """RSM-ED: every offset with raw Euclidean distance <= epsilon (CsvTester.java:59-68)."""
    n, L = data.size, query.size
    m = n - L + 1
    data = data.astype(np.float64)
    query = query.astype(np.float64)
    # FFT-free exact evaluation in chunks to bound memory.
    d2 = np.empty(m)
    chunk = max(1, int(4e7 // L))
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        idx = np.arange(s, e)[:, None] + np.arange(L)[None, :]
        diff = data[idx] - query[None, :]
        d2[s:e] = np.einsum("ij,ij->i", diff, diff)
    keep = d2 <= epsilon * epsilon + 0.0
    offs = np.flatnonzero(keep)
    return offs, np.sqrt(d2[offs])


def nsm_ed(data: np.ndarray, query: np.ndarray, epsilon: float,
           alpha: float | None = None, beta: float | None = None
           ) -> Tuple[np.ndarray, np.ndarray]:
    """NSM/cNSM-ED: z-normalized Euclidean distance, optionally with the cNSM
    constraints |mu_T - mu_Q| <= beta and 1/alpha <= sigma_T/sigma_Q <= alpha
    (CsvTester.java:69-114)."""
    n, L = data.size, query.size
    m = n - L + 1
    data = data.astype(np.float64)
    query = query.astype(np.float64)
    mean_q = query.mean()
    std_q = np.sqrt(np.maximum((query * query).mean() - mean_q * mean_q, 0.0))
    zq = (query - mean_q) / std_q
    mean_t, std_t = sliding_mean_std(data, L)

    ok = std_t > 0
    if alpha is not None:
        ratio = std_t / std_q
        ok &= (np.abs(mean_t - mean_q) <= beta) & (ratio <= alpha) & (ratio >= 1.0 / alpha)

    d2 = np.full(m, np.inf)
    cand = np.flatnonzero(ok)
    chunk = max(1, int(4e7 // L))
    for s in range(0, cand.size, chunk):
        ci = cand[s:s + chunk]
        idx = ci[:, None] + np.arange(L)[None, :]
        zt = (data[idx] - mean_t[ci][:, None]) / std_t[ci][:, None]
        diff = zt - zq[None, :]
        d2[ci] = np.einsum("ij,ij->i", diff, diff)
    keep = d2 <= epsilon * epsilon
    offs = np.flatnonzero(keep)
    return offs, np.sqrt(d2[offs])


def _sliding_dot(data: np.ndarray, q: np.ndarray, block: int = 1 << 22
                 ) -> np.ndarray:
    """dot[i] = sum_j data[i+j] q[j] for every window start, float64
    overlap-save FFT correlation in ``block``-point pieces."""
    n, L = data.size, q.size
    m = n - L + 1
    nfft = 1 << int(np.ceil(np.log2(max(block, 2 * L))))
    step = nfft - L + 1
    Q = np.fft.rfft(q[::-1], nfft)
    out = np.empty(m)
    for s in range(0, m, step):
        piece = data[s:s + nfft]
        full = np.fft.irfft(np.fft.rfft(piece, nfft) * Q, nfft)
        cnt = min(step, m - s)
        out[s:s + cnt] = full[L - 1:L - 1 + cnt]
    return out


def _exact_ed(data: np.ndarray, query: np.ndarray, cand: np.ndarray
              ) -> np.ndarray:
    """Brute-force squared ED of the windows at ``cand`` (rsm_ed's formula)."""
    L = query.size
    d2 = np.empty(cand.size)
    chunk = max(1, int(4e7 // L))
    for s in range(0, cand.size, chunk):
        ci = cand[s:s + chunk]
        diff = data[ci[:, None] + np.arange(L)[None, :]] - query[None, :]
        d2[s:s + ci.size] = np.einsum("ij,ij->i", diff, diff)
    return d2


#: Relative slack of the FFT prefilters below.  float64 FFT correlation and
#: prefix-sum errors are ~1e-12 relative at these sizes; every window within
#: the slack is re-evaluated by brute force, so the slack only costs time.
FFT_FILTER_SLACK = 1e-6


def rsm_ed_fft(data: np.ndarray, query: np.ndarray, epsilon: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """rsm_ed for long series: a float64 FFT estimate of every window's
    distance selects the windows within FFT_FILTER_SLACK of the threshold,
    and those are decided by rsm_ed's own brute-force arithmetic — the same
    answer set in seconds at n=1e8."""
    L = query.size
    data = data.astype(np.float64)
    query = query.astype(np.float64)
    c2 = np.concatenate(([0.0], np.cumsum(data * data)))
    s2 = c2[L:] - c2[:-L]
    q2 = float(query @ query)
    dot = _sliding_dot(data, query)
    est = s2 - 2.0 * dot + q2
    slack = FFT_FILTER_SLACK * (s2 + q2 + 1.0)
    cand = np.flatnonzero(est <= epsilon * epsilon + slack)
    d2 = _exact_ed(data, query, cand)
    keep = d2 <= epsilon * epsilon + 0.0
    return cand[keep], np.sqrt(d2[keep])


def nsm_ed_fft(data: np.ndarray, query: np.ndarray, epsilon: float,
               alpha: float, beta: float) -> Tuple[np.ndarray, np.ndarray]:
    """cNSM-ED for long series, FFT-prefiltered like rsm_ed_fft; windows
    within the slack are decided by nsm_ed's own arithmetic."""
    n, L = data.size, query.size
    data = data.astype(np.float64)
    query = query.astype(np.float64)
    mean_q = query.mean()
    std_q = np.sqrt(np.maximum((query * query).mean() - mean_q * mean_q, 0.0))
    zq = (query - mean_q) / std_q
    mean_t, std_t = sliding_mean_std(data, L)
    ratio = std_t / std_q
    ok = (std_t > 0) & (np.abs(mean_t - mean_q) <= beta) & \
        (ratio <= alpha) & (ratio >= 1.0 / alpha)
    dot = _sliding_dot(data, zq)
    safe = np.where(std_t > 0, std_t, 1.0)
    # sum(((x - mu)/sd - zq)^2) = L - 2 (x . zq - mu * sum(zq)) / sd + zq . zq
    lin = (dot - mean_t * zq.sum()) / safe
    est = L - 2.0 * lin + float(zq @ zq)
    slack = FFT_FILTER_SLACK * (2.0 * L + 2.0 * np.abs(lin) + 1.0)
    cand = np.flatnonzero(ok & (est <= epsilon * epsilon + slack))
    d2 = np.empty(cand.size)
    chunk = max(1, int(4e7 // L))
    for s in range(0, cand.size, chunk):
        ci = cand[s:s + chunk]
        idx = ci[:, None] + np.arange(L)[None, :]
        zt = (data[idx] - mean_t[ci][:, None]) / std_t[ci][:, None]
        diff = zt - zq[None, :]
        d2[s:s + ci.size] = np.einsum("ij,ij->i", diff, diff)
    keep = d2 <= epsilon * epsilon
    return cand[keep], np.sqrt(d2[keep])


def dtw_banded(a: np.ndarray, b: np.ndarray, r: int) -> float:
    """Banded DTW d^2 via a simple full DP restricted to the band (clear + exact)."""
    m = a.size
    INF = np.inf
    prev = np.full(m, INF)
    for i in range(m):
        j_lo = max(0, i - r)
        j_hi = min(m - 1, i + r)
        cur = np.full(m, INF)
        d = (a[i] - b[j_lo:j_hi + 1]) ** 2
        if i == 0:
            cur[0] = (a[0] - b[0]) ** 2
            for j in range(max(1, j_lo), j_hi + 1):
                cur[j] = cur[j - 1] + (a[0] - b[j]) ** 2
        else:
            run = INF
            for j in range(j_lo, j_hi + 1):
                best = min(prev[j], prev[j - 1] if j > 0 else INF, run)
                run = best + d[j - j_lo]
                cur[j] = run
                run = cur[j]
        prev = cur
    return float(prev[m - 1])


def _dtw_batch(windows: np.ndarray, query: np.ndarray, rho: int) -> np.ndarray:
    """Float64 banded DTW over a (B, L) batch.  Uses the NumPy batch DP from
    ops/dtw.py, which is unit-tested cell-exact against the scalar ``dtw_banded``
    here (tests/test_dtw_kernels.py)."""
    from .ops.dtw import dtw_banded_batch_f64
    return dtw_banded_batch_f64(windows, query, rho)


def _dtw_chunks(windows_of, cands: np.ndarray, query: np.ndarray,
                epsilon: float, rho: int, L: int):
    """Evaluate banded DTW over ``cands`` in chunks on every host core (the
    native DP releases the GIL); ``windows_of(ci)`` builds a chunk's (B, L)
    windows.  Returns (offsets, distances) of the answers."""
    from concurrent.futures import ThreadPoolExecutor

    chunk = max(1, int(2e6 // L))

    def one(s):
        ci = cands[s:s + chunk]
        d2 = _dtw_batch(windows_of(ci), query, rho)
        keep = d2 <= epsilon * epsilon
        return ci[keep], np.sqrt(d2[keep])

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        parts = list(pool.map(one, range(0, cands.size, chunk)))
    offs = np.concatenate([p[0] for p in parts]) if parts else np.empty(0, np.int64)
    dists = np.concatenate([p[1] for p in parts]) if parts else np.empty(0)
    return offs.astype(np.int64), dists


def rsm_dtw(data: np.ndarray, query: np.ndarray, epsilon: float, rho: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    """RSM-DTW: banded DTW on raw values (QueryEngineDtw.java:385-452 semantics)."""
    n, L = data.size, query.size
    m = n - L + 1
    data = data.astype(np.float64)
    query = query.astype(np.float64)
    return _dtw_chunks(
        lambda ci: data[ci[:, None] + np.arange(L)[None, :]],
        np.arange(m), query, epsilon, rho, L)


def cnsm_dtw(data: np.ndarray, query: np.ndarray, epsilon: float, rho: int,
             alpha: float, beta: float) -> Tuple[np.ndarray, np.ndarray]:
    """cNSM-DTW: constraints on window mean/std, DTW on z-normalized values
    (NormQueryEngineDtw.java:538-601 semantics)."""
    n, L = data.size, query.size
    m = n - L + 1
    data = data.astype(np.float64)
    query = query.astype(np.float64)
    mean_q = query.mean()
    std_q = np.sqrt(np.maximum((query * query).mean() - mean_q * mean_q, 0.0))
    zq = (query - mean_q) / std_q
    mean_t, std_t = sliding_mean_std(data, L)
    ratio = np.divide(std_t, std_q)
    ok = (std_t > 0) & (np.abs(mean_t - mean_q) <= beta) & \
         (ratio <= alpha) & (ratio >= 1.0 / alpha)
    cand = np.flatnonzero(ok)
    return _dtw_chunks(
        lambda ci: (data[ci[:, None] + np.arange(L)[None, :]]
                    - mean_t[ci][:, None]) / std_t[ci][:, None],
        cand, zq, epsilon, rho, L)


def dedup_overlapping(offsets: np.ndarray, distances: np.ndarray, length: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the best answer among mutually overlapping windows (CsvTester.java:119-134)."""
    order = np.argsort(distances, kind="stable")
    kept_o, kept_d = [], []
    taken = np.zeros(offsets.size, bool)
    for idx in order:
        if taken[idx]:
            continue
        o = offsets[idx]
        kept_o.append(o)
        kept_d.append(distances[idx])
        overlap = (offsets < o + length) & (offsets + length > o)
        taken |= overlap
    return np.asarray(kept_o, np.int64), np.asarray(kept_d)
