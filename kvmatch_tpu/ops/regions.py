"""Region-based phase-2 kernels: sliding distances via batched FFT correlation.

Candidates leave phase 1 as *contiguous intervals* of window offsets.  The
per-candidate gather kernels (ops/ed.py) read L points per candidate — O(m*L)
HBM traffic for an interval of m offsets; the reference pays the analogous cost
as batched KV range reads of MAX_SCAN_DATA_LENGTH points
(QueryEngine.java:341-363, NormQueryEngine.java:420-470).  These kernels
instead gather each interval's REGION once (m+L-1 points) and evaluate all of
its offsets with one batched rfft/irfft cross-correlation (see _correlate):

    corr[i] = sum_j x[i+j] * q[j]                       (batched FFT)
    raw ED:   d2[i] = S2[i] - 2*corr[i] + ||q||^2       (sliding S2 by doubling)
    z-norm:   d2[i] = 2L - 2*corr_hat[i] / sigma[i]      (MASS form; q_hat is
              z-normalized so sum(q_hat)=0, sum(q_hat^2)=L)

Numerics: the z-norm form is well-conditioned (everything is O(L)).  The raw form
subtracts large near-equal terms, so each distance carries a per-candidate error
bound  err[i] ~= C*eps32*(S2[i] + 2|corr[i]| + q2)  that the caller adds to its
guard band before the exact float64 confirmation — exactness is preserved, a
noisier device estimate only sends a few more near-threshold offsets to the host.

Data is centered by a global constant before correlating (distances are shift
invariant) to shrink the raw-path magnitudes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# float32 round-off amplification constant for the error bounds (covers the
# log-depth accumulation of FFT + sliding sums with slack to spare).
ERR_C = 64.0 * np.finfo(np.float32).eps
# FFT correlation error coefficient: the measured max error of the device FFT
# correlation against float64, |err| / (||x||_2 * ||q||_2), at the region
# widths the engines launch stays far below it (chip_smoke.py prints the
# measurement; tests/test_regions.py covers the CPU).
FFT_ERR_C = 1e-5


def _gather_regions(data: jnp.ndarray, starts: jnp.ndarray, r_len: int) -> jnp.ndarray:
    """Region slabs share the window gather (ops/ed.py): region starts are
    just window offsets with a longer length."""
    from .ed import _gather_windows
    return _gather_windows(data, starts, r_len)


def _sliding_sum_rows(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """Sliding sums of width w along axis 1 by log-depth doubling (see
    ops/sliding.py); x: (B, R) -> (B, R-w+1)."""
    n = x.shape[1]
    pow_sums = {1: x}
    width = 1
    while width * 2 <= w:
        s = pow_sums[width]
        pow_sums[width * 2] = s[:, : n - 2 * width + 1] + s[:, width: n - width + 1]
        width *= 2
    out_len = n - w + 1
    acc = None
    offset, rem = 0, w
    for p in sorted(pow_sums, reverse=True):
        if rem >= p:
            piece = pow_sums[p][:, offset: offset + out_len]
            acc = piece if acc is None else acc + piece
            offset += p
            rem -= p
    return acc


def _correlate(x: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """corr[b, i] = sum_j x[b, i+j] q[j]; shared filter across rows (one query).

    FFT-based like the grouped variant: batched f32 FFT correlation keeps a
    bounded relative error (FFT_ERR_C, re-measured on the card by
    chip_smoke.py) whatever precision a backend picks for f32 convolutions,
    and the error bounds below assume it."""
    R = x.shape[1]
    L = q.shape[0]
    N = 1 << max(int(np.ceil(np.log2(R))), 1)
    X = jnp.fft.rfft(x, N)
    Q = jnp.fft.rfft(q[::-1], N)
    full = jnp.fft.irfft(X * Q[None, :], N)
    return full[:, L - 1: R]


@functools.partial(jax.jit, static_argnames=("length", "m_per_region"))
def region_ed_distances(data: jnp.ndarray, query_centered: jnp.ndarray,
                        starts: jnp.ndarray, length: int, m_per_region: int,
                        center=np.float32(0.0)):
    """Raw squared ED for every offset in [starts[b], starts[b]+M) per region.

    ``center`` is subtracted from the gathered data (distances are shift
    invariant); pass the same constant used to center ``query_centered`` — it
    shrinks the magnitudes feeding the cancellation-prone d2 formula.
    Returns (d2 (B, M), err (B, M)) — err is the f32 guard addition.
    """
    r_len = m_per_region + length - 1
    x = _gather_regions(data, starts, r_len) - center
    corr = _correlate(x, query_centered)
    s2 = _sliding_sum_rows(x * x, length)
    q2 = jnp.sum(query_centered * query_centered)
    d2 = jnp.maximum(s2 - 2.0 * corr + q2, 0.0)
    err = ERR_C * (s2 + 2.0 * jnp.abs(corr) + q2) + \
        2.0 * FFT_ERR_C * jnp.sqrt(jnp.maximum(s2 * q2, 0.0))
    return d2, err


@functools.partial(jax.jit, static_argnames=("length", "m_per_region"))
def region_znorm_distances(data: jnp.ndarray, query_hat: jnp.ndarray,
                           starts: jnp.ndarray, length: int, m_per_region: int):
    """Z-normalized squared ED (MASS form) + window mean/std per offset.

    ``query_hat`` is the z-normalized query; data is raw (NOT centered — the
    z-normalization removes the level).  Returns (d2, mean, std), each (B, M).
    """
    r_len = m_per_region + length - 1
    x = _gather_regions(data, starts, r_len)
    corr = _correlate(x, query_hat)
    inv_l = np.float32(1.0 / length)
    s1 = _sliding_sum_rows(x, length)
    s2 = _sliding_sum_rows(x * x, length)
    mean = s1 * inv_l
    var = jnp.maximum(s2 * inv_l - mean * mean, 0.0)
    std = jnp.sqrt(var)
    safe = jnp.where(std > 0, std, 1.0)
    two_l = np.float32(2.0 * length)
    d2 = jnp.maximum(two_l - 2.0 * corr / safe, 0.0)
    d2 = jnp.where(std > 0, d2, jnp.inf)
    return d2, mean, std


def _correlate_grouped(x: jnp.ndarray, qs: jnp.ndarray) -> jnp.ndarray:
    """Per-row filters: corr[b, i] = sum_j x[b, i+j] qs[b, j].

    A grouped conv (feature_group_count=B) would express this directly, but
    thousands of groups are a poor fit for convolution kernels; batched FFT
    correlation is group-free and one fused launch.  The f32 FFT round-off is
    covered by the per-offset error columns the region kernels return."""
    R = x.shape[1]
    L = qs.shape[1]
    N = 1 << max(int(np.ceil(np.log2(R))), 1)
    X = jnp.fft.rfft(x, N)
    Q = jnp.fft.rfft(qs[:, ::-1], N)
    full = jnp.fft.irfft(X * Q, N)
    return full[:, L - 1: R]


@functools.partial(jax.jit, static_argnames=("length", "m_per_region"))
def region_ed_distances_multi(data: jnp.ndarray, queries_centered: jnp.ndarray,
                              starts: jnp.ndarray, qids: jnp.ndarray,
                              length: int, m_per_region: int,
                              center=np.float32(0.0)):
    """Multi-query raw ED over regions; queries_centered (Q, L), one query per
    region row via qids."""
    r_len = m_per_region + length - 1
    x = _gather_regions(data, starts, r_len) - center
    qs = queries_centered[qids]
    corr = _correlate_grouped(x, qs)
    s2 = _sliding_sum_rows(x * x, length)
    q2 = jnp.sum(qs * qs, axis=1)[:, None]
    d2 = jnp.maximum(s2 - 2.0 * corr + q2, 0.0)
    err = ERR_C * (s2 + 2.0 * jnp.abs(corr) + q2) + \
        2.0 * FFT_ERR_C * jnp.sqrt(jnp.maximum(s2 * q2, 0.0))
    return d2, err


@functools.partial(jax.jit, static_argnames=("length", "m_per_region"))
def region_znorm_distances_multi(data: jnp.ndarray, queries_hat: jnp.ndarray,
                                 starts: jnp.ndarray, qids: jnp.ndarray,
                                 length: int, m_per_region: int):
    r_len = m_per_region + length - 1
    x = _gather_regions(data, starts, r_len)
    corr = _correlate_grouped(x, queries_hat[qids])
    inv_l = np.float32(1.0 / length)
    s1 = _sliding_sum_rows(x, length)
    s2 = _sliding_sum_rows(x * x, length)
    mean = s1 * inv_l
    var = jnp.maximum(s2 * inv_l - mean * mean, 0.0)
    std = jnp.sqrt(var)
    safe = jnp.where(std > 0, std, 1.0)
    two_l = np.float32(2.0 * length)
    d2 = jnp.maximum(two_l - 2.0 * corr / safe, 0.0)
    d2 = jnp.where(std > 0, d2, jnp.inf)
    # FFT + MASS-cancellation error bound: 2*err_corr/sigma with
    # err_corr ~ FFT_ERR_C * ||x_win|| * ||q_hat|| = FFT_ERR_C*sqrt(s2*L).
    err = (2.0 * FFT_ERR_C * jnp.sqrt(jnp.maximum(s2, 0.0) * length)
           + ERR_C * two_l) / safe
    return d2, mean, std, err


def _near_compact(near: jnp.ndarray, near_k: int):
    """(count, rows, cols) of up to ``near_k`` True cells of a 2-D mask.

    A flat jnp.nonzero over the full (B, M) mask is a whole-array compaction —
    measured 600 ms of an 806 ms launch at B*M=134M cells (the flood shape).
    Two-level form: nonzero a 256-wide block-any reduction (B*M/256 cells),
    gather only the matched blocks, nonzero the small (near_k, 256) matrix.
    Exact for count <= near_k: every non-empty block holds >= 1 match, so
    matched blocks <= count <= near_k fit the first compaction, and
    jnp.nonzero's ascending order + end-padding keep the first ``count``
    outputs the true matches in ascending position order (duplicated fill
    blocks can only append PAST count; callers read [:count] and fall back
    when count > near_k, exactly as with the flat form)."""
    B, M = near.shape
    F = 256
    if M % F:
        near = jnp.pad(near, ((0, 0), (0, F - M % F)))
    Mp = near.shape[1]
    count = jnp.sum(near.astype(jnp.int32))
    flat = near.reshape((B * Mp) // F, F)
    (bidx,) = jnp.nonzero(flat.any(axis=1), size=near_k, fill_value=0)
    sub = flat[bidx]                                   # (near_k, F) rows
    (fl2,) = jnp.nonzero(sub.ravel(), size=near_k, fill_value=0)
    g = bidx[fl2 // F] * F + fl2 % F
    return count, (g // Mp).astype(jnp.int32), (g % Mp).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("length", "m_per_region", "near_k"))
def region_ed_near_multi(data: jnp.ndarray, queries_centered: jnp.ndarray,
                         starts: jnp.ndarray, qids: jnp.ndarray,
                         vfrom: jnp.ndarray, vto: jnp.ndarray,
                         threshs: jnp.ndarray,
                         length: int, m_per_region: int, near_k: int,
                         center=np.float32(0.0)):
    """Region ED with ON-DEVICE near-set selection: returns (count, rows, cols)
    of at most ``near_k`` offsets whose guarded d2 is under the per-query
    threshold.  D2H shrinks from (B, M) matrices to the (typically tiny)
    survivor list — decisive under a slow host link, free on real hardware."""
    d2, err = region_ed_distances_multi(data, queries_centered, starts, qids,
                                        length, m_per_region, center)
    col = jnp.arange(m_per_region)[None, :]
    near = ((col >= vfrom[:, None]) & (col < vto[:, None])
            & (d2 <= threshs[qids][:, None] + err))
    return _near_compact(near, near_k)


@functools.partial(jax.jit, static_argnames=("length", "m_per_region", "near_k"))
def region_znorm_near_multi(data: jnp.ndarray, queries_hat: jnp.ndarray,
                            starts: jnp.ndarray, qids: jnp.ndarray,
                            vfrom: jnp.ndarray, vto: jnp.ndarray,
                            threshs: jnp.ndarray, cons: jnp.ndarray,
                            length: int, m_per_region: int, near_k: int):
    """Z-norm region kernel with on-device constraint + near-set selection;
    ``cons`` rows are (alpha, beta, mu_q, sd_q, cg) per query."""
    d2, mean, std, err = region_znorm_distances_multi(
        data, queries_hat, starts, qids, length, m_per_region)
    a = cons[qids, 0][:, None]
    b = cons[qids, 1][:, None]
    mq = cons[qids, 2][:, None]
    sq = cons[qids, 3][:, None]
    cg = cons[qids, 4][:, None]
    ratio = std / sq
    ok = ((jnp.abs(mean - mq) <= b + cg) & (ratio <= a + cg)
          & (ratio >= 1.0 / a - cg) & (std > 0))
    col = jnp.arange(m_per_region)[None, :]
    near = (ok & (col >= vfrom[:, None]) & (col < vto[:, None])
            & (d2 <= threshs[qids][:, None] + err))
    return _near_compact(near, near_k)


def coalesce_intervals(left: np.ndarray, right: np.ndarray, gap: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge sorted disjoint intervals whose gaps are <= ``gap``.

    Dense candidate sets at large n often have millions of short intervals a
    few positions apart; packing them one region per interval reads the
    (M+L-1)-point region row for a handful of useful offsets.  Coalescing lets
    one region serve many intervals — the FFT evaluates the gap offsets too,
    but those were pruned by a SOUND phase-1 bound, so their true distance
    exceeds epsilon and they can only add guard-band host rechecks, never
    answers (exactness preserved by the float64 confirm)."""
    if left.size <= 1:
        return left, right
    starts = np.empty(left.size, bool)
    starts[0] = True
    starts[1:] = left[1:] - right[:-1] - 1 > gap
    first = np.flatnonzero(starts)
    return left[first], np.maximum.reduceat(right, first)


def pack_regions(left: np.ndarray, right: np.ndarray, n: int, length: int,
                 m_per_region: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split candidate intervals into fixed-M region rows.

    Returns (starts (B,), valid_from (B,), valid_to (B,)): region b covers window
    offsets starts[b] + [valid_from[b], valid_to[b]).  Starts are clamped so the
    full region [start, start + M + L - 1) stays inside the data; the valid
    window compensates for the clamp.
    """
    m = m_per_region
    sizes = right - left + 1
    pieces = (sizes + m - 1) // m
    total = int(pieces.sum())
    rep_left = np.repeat(left, pieces)
    rep_right = np.repeat(right, pieces)
    offs = np.concatenate(([0], np.cumsum(pieces)[:-1]))
    within = (np.arange(total) - np.repeat(offs, pieces)) * m
    starts = rep_left + within
    ends = np.minimum(starts + m - 1, rep_right)  # inclusive last offset
    r_len = m + length - 1
    clamped = np.minimum(starts, n - r_len)
    clamped = np.maximum(clamped, 0)
    valid_from = starts - clamped
    valid_to = ends - clamped + 1
    return clamped.astype(np.int64), valid_from.astype(np.int64), valid_to.astype(np.int64)
