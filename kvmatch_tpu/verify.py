"""Phase-2 drivers: batched device distance evaluation + exact host confirmation.

Replaces the reference's per-offset early-abandon scans (QueryEngine.java:343-363,
NormQueryEngine.java:454-527, QueryEngineDtw.java:385-452) with:

  1. fixed-shape candidate batches on the device (padded to the configured batch size
     so jit re-traces only per query length),
  2. a one-sided guard band: every offset whose device f32 distance^2 is below
     eps^2 + guard is re-evaluated exactly in float64 on the host.  Device work
     prunes ~all losers at HBM bandwidth; the handful of near-threshold survivors
     get exact confirmation, so the final answer set equals the float64 oracle's.

The batching also replaces MAX_SCAN_DATA_LENGTH chunked reads
(NormQueryEngine.java:60,454-479): the series is device-resident, so "scans" are
gathers, and batch size is a tiling knob rather than an IO knob.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def pad_batches(offsets: np.ndarray, batch: int) -> np.ndarray:
    """Pad to a multiple of ``batch`` (repeating the first offset, masked later)."""
    pad = (-offsets.size) % batch
    if pad:
        offsets = np.concatenate([offsets, np.full(pad, offsets[0], offsets.dtype)])
    return offsets


#: HBM working-set cap for one phase-2 launch, in ELEMENTS of the (B, width)
#: candidate matrix.  The deepest stage (z-norm LB cascade) holds ~8 live
#: (B, width) f32 temps, so 2^27 elements keeps one launch under ~4.3 GB of
#: temps next to the resident series (an uncapped B=65536 x L=8192 launch
#: compiles to a 16.25 GB program).
VERIFY_TEMP_ELEMS = 1 << 27


def bucket_size(m: int, lo: int = 1024, hi: int = 65536, width: int = 1) -> int:
    """Padded launch size: next power of two >= m within [lo, hi].  Each distinct
    bucket size compiles once; a whole candidate set up to ``hi`` runs as ONE
    device launch, so small loads pay one launch and one transfer.  ``width``
    is the per-candidate row length (L, or M+L-1 for regions): long rows cap
    the batch so the launch's temp working set fits HBM."""
    hi = max(lo, min(hi, VERIFY_TEMP_ELEMS // max(width, 1)))
    b = lo
    while b < m and 2 * b <= hi:
        b *= 2
    return b


def run_bucketed(kernel: Callable, m: int, *arrays: np.ndarray,
                 lo: int = 1024, hi: int = 65536, width: int = 1):
    """Run ``kernel(*slices)`` over bucket-padded chunks of the given parallel
    arrays; returns the kernel outputs (array or tuple) trimmed to ``m`` rows."""
    batch = bucket_size(m, lo, hi, width)
    padded = [pad_batches(a, batch) for a in arrays]
    outs = None
    for s in range(0, padded[0].size, batch):
        res = kernel(*(p[s:s + batch] for p in padded))
        if not isinstance(res, tuple):
            res = (res,)
        res = tuple(np.asarray(r) for r in res)
        if outs is None:
            outs = [[r] for r in res]
        else:
            for acc, r in zip(outs, res):
                acc.append(r)
    trimmed = tuple(np.concatenate(acc)[:m] for acc in outs)
    return trimmed if len(trimmed) > 1 else trimmed[0]


def device_distances(offsets: np.ndarray, batch: int,
                     kernel: Callable[[np.ndarray], np.ndarray],
                     width: int = 1) -> np.ndarray:
    """Run ``kernel`` (a jit'd (B,)->... distance function) over bucket-padded
    batches; ``batch`` is the minimum bucket size."""
    if offsets.size == 0:
        return np.empty(0, np.float32)
    return run_bucketed(kernel, offsets.size, offsets.astype(np.int32),
                        lo=batch, width=width)


def guard_threshold(eps2: float, length: int, guard: float) -> float:
    """Absolute guard-band width above eps^2 for f32 device distances."""
    return guard * (eps2 + 1.0) + 1e-4 * length


#: Safety factor for ds_guard.  The measured worst case over adversarial data
#: (scripts/measure_dtw_f32_error.py, tests/test_dtw_guard.py) needs C ~ a few;
#: 32 leaves >8x margin while keeping the band ~30x tighter than the f32 guard.
DS_GUARD_C = 32.0

_EPS32 = float(np.finfo(np.float32).eps)


def ds_guard(d2: np.ndarray, length: int, amp: np.ndarray) -> np.ndarray:
    """Error bound for the double-single banded-DTW device distance vs the
    exact f64 pipeline on f64 inputs (ops/dtw.dtw_banded_batch_ds_multi).

    The DS accumulation itself is exact to ~2^-46, so the bound is dominated by
    f32 INPUT rounding: each input element carries |delta| <= eps32 * amp, and a
    warping path of length <= 2L perturbs d2 by at most

        2 * sum_path |a - q| * delta + path * delta^2
        <= 2 * sqrt(2L * d2) * eps32 * amp  +  2L * (eps32 * amp)^2      (C-S)

    with ``amp`` the max |input| over the window and query (plus the coherent
    mean/std rounding terms of the z-norm path, which have the same sqrt shape
    — see dtw_stage_znorm_ds_multi).  DS_GUARD_C absorbs the constants; the
    bound is validated against adversarial property tests in
    tests/test_dtw_guard.py."""
    amp = np.maximum(np.asarray(amp, np.float64), 1.0)
    d2 = np.maximum(np.asarray(d2, np.float64), 0.0)
    return (DS_GUARD_C * _EPS32 * np.sqrt(2.0 * length * (d2 + 1.0)) * amp
            + 4.0 * length * (_EPS32 * amp) ** 2)


def run_region_near(kernel: Callable, starts: np.ndarray, vfrom: np.ndarray,
                    vto: np.ndarray, qids: np.ndarray, near_k: int,
                    lo: int = 32, hi: int = 8192, width: int = 1):
    """Drive an on-device near-selection region kernel over bucket-padded chunks.

    ``kernel(starts, qids, vfrom, vto) -> (count, rows, cols)`` with rows/cols
    chunk-local.  Padding rows carry vfrom=vto=0 so they match nothing.  Returns
    (near_offsets, near_qids) or None if any chunk overflowed ``near_k`` (the
    caller then falls back to the full-matrix path)."""
    m = starts.size
    batch = bucket_size(m, lo, hi, width)
    pad = (-m) % batch
    if pad:
        z = np.zeros(pad, np.int64)
        starts = np.concatenate([starts, z])
        qids = np.concatenate([qids, np.zeros(pad, qids.dtype)])
        vfrom = np.concatenate([vfrom, z])
        vto = np.concatenate([vto, z])
    offs_out, qid_out = [], []
    for s in range(0, starts.size, batch):
        cnt, rows, cols = kernel(starts[s:s + batch].astype(np.int32),
                                 qids[s:s + batch],
                                 vfrom[s:s + batch].astype(np.int32),
                                 vto[s:s + batch].astype(np.int32))
        cnt = int(cnt)
        if cnt > near_k:
            return None
        rows = np.asarray(rows)[:cnt]
        cols = np.asarray(cols)[:cnt]
        offs_out.append(starts[s:s + batch][rows] + cols)
        qid_out.append(np.asarray(qids[s:s + batch])[rows])
    if not offs_out:
        return np.empty(0, np.int64), np.empty(0, np.int32)
    return np.concatenate(offs_out), np.concatenate(qid_out)
