"""Fully device-side KV-index construction.

A builder that runs the bucket pass on the device but groups on the host is
capped at single-digit Mpts/s end to end by one host core.  This module keeps
the WHOLE pipeline on the device:

    bucket ids -> RLE with the 256-position cap -> bucket histogram ->
    row ids -> boundary-local merge policy -> segmented union + cap resplit ->
    per-row statistics

using only prefix scans, cumsums and integer scatters (deterministic)
— no sort: RLE emits intervals in position order, and because every window
start has exactly one mean bucket, the intervals of a scale TILE the position
axis, so "group by bucket" is a histogram + rank, and "union adjacent rows"
is run detection over the position-ordered stream.

The variable-width row merge (IndexBuilder.java:308-346) runs as the
reference's ACCUMULATING descending-key scan — but on the HOST, over row
METADATA only (per-row interval counts + an adjacency-join histogram, a few
hundred KB), between two device programs:

    stage A (device): RLE + bucket histogram + join histogram
    host: _merge_scan -> grp_of_row            (O(rows), rows <= ~1e5)
    stage B (device): apply grouping, segmented union + cap resplit, stats

Deciding each key boundary INDEPENDENTLY from a pairwise test CHAINS in the
key-range tails (every sparse boundary passes, so whole tails collapse into
one mega-row), which wrecks the planner's selectivity estimates (23.5M
candidates per cNSM query at n=1e8).  The accumulating scan stops chains exactly like the reference: the
required union reduction is 20% of the RUNNING group size, so it grows as the
group grows.  Union sizes are estimated from position-adjacent interval pairs
whose rows are <= DMAX buckets apart (exact union would need the interval
lists themselves), bounded below by the cap-resplit floor
ceil(group_offsets/256) — without the floor the estimate sits flat in the
key-range tails, where joins ~= counts, and absorbs entire tails into
mega-rows (see _merge_scan).  Merges can still differ from the host
builder's in edge cases — engines are exact with either index (phase 2
confirms in float64 regardless of which rows fed phase 1).

Outputs stay DEVICE-RESIDENT as the position-sorted interval view
(piece_left, piece_right, piece_row); only row metadata (keys, counts,
cumulative statistics — a few KB) crosses to the host at build time.  The
host row-CSR view is materialized lazily on first host-path access
(index/structure.IndexScale), so a build + fly-probe + device-verify query
never pays the interval D2H at all.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Dict, Optional

import numpy as np

from ..config import DEFAULT_INDEX_CONFIG, IndexConfig
from ..utils import rounding
from .structure import Index, IndexScale

logger = logging.getLogger("kvmatch_tpu")

#: Histogram capacity (distinct mean buckets) of the device pipeline.  At the
#: default d=0.5 grid this covers a mean range of ~260k units — far beyond any
#: real series; the host wrapper asserts the actual range fits and falls back
#: to the host builder otherwise.
NB = 1 << 20

_SENT = np.int32(1 << 30)  # bucket sentinel for padded tail positions


def _prefix_max(x, axis=0):
    # lax.cummax lowers to a native HLO scan; lax.associative_scan(
    # jnp.maximum) over >=1e7 elements unrolls into a log-depth graph that
    # compiles for minutes — never use it on the position axis.
    import jax
    return jax.lax.cummax(x, axis=axis)


#: Row-metadata slice width returned to the host (rows per scale never come
#: close; asserted after the pull).
GMAX = 1 << 17


#: Max bucket distance between the rows of a position-adjacent interval pair
#: counted by the join histogram.  Pairs further apart are dropped (union
#: sizes get over-estimated, merges get rarer — conservative).
DMAX = 8


@functools.lru_cache(maxsize=1)
def _pipeline_a_jit():
    import jax
    return jax.jit(_scale_pipeline_a, static_argnames=("cap",))


@functools.lru_cache(maxsize=1)
def _pipeline_b_jit():
    import jax
    return jax.jit(_scale_pipeline_b, static_argnames=("cap",))


@functools.lru_cache(maxsize=None)
def _bucket_prog(w: int, u: int, pos_of_d: int):
    """Single-scale bucket ids from the raw data, padded to M = n - u + 1.

    One small program per scale (vs one (S, M) stack program) so each scale's
    2 GB-at-n=1e8 bucket array is freed as soon as its pipeline consumes it —
    the all-scales stack alone is 5x that and was part of the HBM overflow
    that crashed the worker at n=1e8 (round 3).
    """
    import jax
    import jax.numpy as jnp
    from ..ops.sliding import bucketize_means, sliding_sums

    @jax.jit
    def prog(data):
        s = sliding_sums(data, (u, w) if w != u else (u,))[w]
        b = bucketize_means(s, w, pos_of_d)
        pad = w - u  # M - m_w
        if pad:
            b = jnp.concatenate([b, jnp.full(pad, _SENT, jnp.int32)])
        return b

    return prog


#: Piece D2H slices are rounded up to this granularity so the tiny slice
#: programs hit a bounded set of shapes (3 arrays x 5 scales per build).
_SLICE_Q = 1 << 22


@functools.lru_cache(maxsize=None)
def _slice_prog(m: int, k: int):
    import jax

    def prog(pl, pr, prow):
        return pl[:k], pr[:k], prow[:k]

    return jax.jit(prog)




def _scale_pipeline_a(b, bucket_lo, n_valid, cap: int):
    """Stage A: RLE + bucket histogram + adjacency-join histogram on device.

    b: i32[M] bucket ids, positions >= n_valid carry _SENT.
    Returns (n_iv, n_rows, row_bucket i32[GMAX], row_counts i32[GMAX],
             row_offs i32[GMAX], joins i32[GMAX*DMAX],
             il i32[M], ir i32[M], r_iv i32[M]);
    the first six cross to the host (a few hundred KB), the interval arrays
    stay device-resident for stage B.
    """
    import jax.numpy as jnp

    M = b.shape[0]
    pos = jnp.arange(M, dtype=jnp.int32)
    valid = pos < n_valid

    # --- RLE with cap ------------------------------------------------------
    change = jnp.concatenate([jnp.ones(1, bool), b[1:] != b[:-1]])
    run_start = _prefix_max(jnp.where(change, pos, -1))
    within = pos - run_start
    start = (change | (within % cap == 0)) & valid
    iid = jnp.cumsum(start.astype(jnp.int32)) - 1     # interval id per position
    n_iv = jnp.where(valid[-1], iid[-1] + 1,
                     jnp.max(jnp.where(valid, iid, -1)) + 1)
    dest = jnp.where(start, iid, M)
    il = jnp.zeros(M + 1, jnp.int32).at[dest].set(pos, mode="drop")[:M]
    ib = jnp.zeros(M + 1, jnp.int32).at[dest].set(b, mode="drop")[:M]
    # interval k's right = (start position of interval k+1) - 1; last = n-1
    ir = jnp.zeros(M + 1, jnp.int32).at[
        jnp.where(start & (iid > 0), iid - 1, M)].set(pos - 1, mode="drop")[:M]
    ir = ir.at[jnp.maximum(n_iv - 1, 0)].set(n_valid - 1)
    iv_ok = jnp.arange(M) < n_iv

    # --- histogram -> rows -------------------------------------------------
    hidx = jnp.where(iv_ok, jnp.clip(ib - bucket_lo, 0, NB - 1), NB)
    hist = jnp.zeros(NB + 1, jnp.int32).at[hidx].add(1, mode="drop")[:NB]
    present = hist > 0
    row_of_bucket = jnp.cumsum(present.astype(jnp.int32)) - 1
    n_rows = jnp.sum(present.astype(jnp.int32))
    r_iv = jnp.where(iv_ok, row_of_bucket[jnp.clip(ib - bucket_lo, 0, NB - 1)],
                     -1)
    # compact per-row arrays (row index <- bucket)
    rdst = jnp.where(present, row_of_bucket, NB)
    row_bucket = jnp.zeros(NB + 1, jnp.int32).at[rdst].set(
        jnp.arange(NB, dtype=jnp.int32) + bucket_lo, mode="drop")[:GMAX]
    row_counts = jnp.zeros(NB + 1, jnp.int32).at[rdst].set(
        hist, mode="drop")[:GMAX]
    # per-row OFFSET totals (sum of piece lengths) — the merge scan's
    # cap-resplit floor needs them (see _merge_scan)
    odst = jnp.where(iv_ok, jnp.clip(r_iv, 0, GMAX - 1), GMAX)
    row_offs = jnp.zeros(GMAX + 1, jnp.int32).at[odst].add(
        jnp.where(iv_ok, ir - il + 1, 0), mode="drop")[:GMAX]

    # --- adjacency-join histogram ------------------------------------------
    # The buckets tile the position axis, so consecutive intervals are always
    # position-adjacent; a pair (i, i+1) whose rows differ by delta in
    # [1, DMAX] is a union join charged to (min_row, delta).
    r_next = jnp.concatenate([r_iv[1:], jnp.full(1, -1, jnp.int32)])
    delta = jnp.abs(r_next - r_iv)
    pair_ok = iv_ok & (jnp.arange(M) < n_iv - 1) & (delta >= 1) & (delta <= DMAX)
    jdst = jnp.where(pair_ok,
                     jnp.minimum(r_iv, r_next) * DMAX + (delta - 1),
                     GMAX * DMAX)
    joins = jnp.zeros(GMAX * DMAX + 1, jnp.int32).at[jdst].add(
        1, mode="drop")[:GMAX * DMAX]
    return (n_iv, n_rows, row_bucket, row_counts, row_offs, joins,
            il, ir, r_iv)


def _merge_scan(counts: np.ndarray, offs: np.ndarray, joins: np.ndarray,
                count_factor: float, shrink_factor: float, cap: int):
    """The reference's accumulating row merge (IndexBuilder.java:308-346) on
    row metadata: descending-key scan; row idx merges into the RUNNING group
    when its interval count < count_factor*avg and the estimated union size
    shrinks below shrink_factor*(parts sum).  ``joins[r, d-1]`` counts
    position-adjacent interval pairs between rows r and r+d; ``offs[r]`` is
    row r's total offsets (sum of piece lengths).

    The union estimate is  max(parts - joins, ceil(group_offsets / cap)).
    The join term alone collapses key-range tails: there, nearly every piece
    is position-adjacent to a piece of a nearby row (joins ~= counts), so the
    estimate stays flat while the true union — long coalesced runs RE-SPLIT
    at the 256-offset cap (IndexNodeUtils.mergeIndexNode) — keeps growing
    with the group.  ceil(group_offsets/cap) is a hard lower bound on the
    capped union (disjoint runs: sum of ceils >= ceil of sum), tight exactly
    in that coalesced-tail regime, and inert in the key-range center where
    runs are far shorter than the cap (measured n=1e8 w=25: the uncorrected
    estimate sat at ~85 pieces while absorbing 9552 rows / 3.85M offsets into
    one mega-row; the host's exact union is ~15k pieces and stops the chain).

    Returns (grp_of_row i64[R], n_groups); group ids ascend with key order
    and each group's key is its first row's bucket."""
    R = int(counts.size)
    if R == 0:
        return np.zeros(0, np.int64), 0
    thresh = count_factor * float(counts.mean())
    shrink = float(shrink_factor)
    merge_up = np.zeros(R, bool)        # row idx joins the group of row idx+1
    joins_f = joins.astype(np.float64, copy=False)
    counts_f = counts.astype(np.float64, copy=False)
    offs_f = offs.astype(np.float64, copy=False)
    top = R - 1
    acc = counts_f[R - 1]
    acc_off = offs_f[R - 1]
    for idx in range(R - 2, -1, -1):
        c = counts_f[idx]
        if c < thresh:
            d = top - idx
            j = joins_f[idx, :d].sum() if d < DMAX else joins_f[idx].sum()
            floor = np.ceil((acc_off + offs_f[idx]) / cap)
            union = max(acc + c - j, floor)
            if union < shrink * (acc + c):
                acc = union
                acc_off += offs_f[idx]
                merge_up[idx] = True
                continue
        top = idx
        acc = c
        acc_off = offs_f[idx]
    grp = np.zeros(R, np.int64)
    np.cumsum(~merge_up[:-1], out=grp[1:])
    return grp, int(grp[-1]) + 1


def _scale_pipeline_b(il, ir, r_iv, n_iv, grp_of_row, cap: int):
    """Stage B: apply the host grouping, segmented union + cap resplit, and
    per-group statistics on device.

    il/ir/r_iv: stage-A interval arrays (i32[M], first n_iv valid).
    grp_of_row: i32[GMAX] host-computed group id per row (ascending).
    Returns (np_pieces, piece_left i32[M], piece_right i32[M],
             piece_row i32[M], g_n_iv i32[GMAX], g_n_off i32[GMAX]).
    """
    import jax.numpy as jnp

    M = il.shape[0]
    iv_ok = jnp.arange(M) < n_iv

    # --- segmented union + cap resplit -------------------------------------
    g_iv = jnp.where(iv_ok, grp_of_row[jnp.clip(r_iv, 0, GMAX - 1)], -1)
    g_prev = jnp.concatenate([jnp.full(1, -2, jnp.int32), g_iv[:-1]])
    il_prev = jnp.concatenate([jnp.full(1, -9, jnp.int32), ir[:-1]])
    ustart = iv_ok & ((g_iv != g_prev) | (il != il_prev + 1))
    uid = jnp.cumsum(ustart.astype(jnp.int32)) - 1
    n_runs = jnp.max(jnp.where(iv_ok, uid, -1)) + 1
    udst = jnp.where(ustart, uid, M)
    runL = jnp.zeros(M + 1, jnp.int32).at[udst].set(il, mode="drop")[:M]
    rung = jnp.zeros(M + 1, jnp.int32).at[udst].set(
        jnp.where(iv_ok, g_iv, 0), mode="drop")[:M]
    # run right = right of its last interval: scatter interval rights at uid
    # for run-last intervals — the next interval starts a new run, or this is
    # the LAST VALID interval (whose successor is masked, so ustart[i+1] is
    # False there and would silently drop the final run)
    ulast = iv_ok & (jnp.concatenate([ustart[1:], jnp.ones(1, bool)])
                     | (jnp.arange(M) == n_iv - 1))
    runR = jnp.zeros(M + 1, jnp.int32).at[
        jnp.where(ulast, uid, M)].set(ir, mode="drop")[:M]

    run_ok = jnp.arange(M) < n_runs
    run_len = jnp.where(run_ok, runR - runL + 1, 0)
    pieces = (run_len + cap - 1) // cap
    piece_ptr = jnp.cumsum(pieces) - pieces          # exclusive prefix
    np_pieces = jnp.where(n_runs > 0,
                          piece_ptr[jnp.maximum(n_runs - 1, 0)]
                          + pieces[jnp.maximum(n_runs - 1, 0)], 0)
    # Expand runs into pieces by FILL-FORWARD of per-run values into piece
    # space: delta-encode along the (compacted) run axis, scatter each delta
    # at the run's first piece position, cumsum over the piece axis.  The
    # obvious searchsorted(incl, j)-then-gather formulation compiles
    # searchsorted over a computed cumsum at M=1e8, which has stalled the
    # compiler; scatter+cumsum are the same primitives stages 1-4 already use
    # at this size.
    jidx = jnp.arange(M, dtype=jnp.int32)
    pdst = jnp.where(run_ok & (pieces > 0), piece_ptr, M)

    def _fill(vals):
        prev = jnp.concatenate([jnp.zeros(1, vals.dtype), vals[:-1]])
        dv = vals - prev
        scat = jnp.zeros(M + 1, vals.dtype).at[pdst].add(dv, mode="drop")[:M]
        return jnp.cumsum(scat)

    p_ok = jidx < np_pieces
    p_left = jnp.where(p_ok, _fill(runL) + (jidx - _fill(piece_ptr)) * cap, 0)
    p_right = jnp.where(p_ok, jnp.minimum(p_left + cap - 1, _fill(runR)), -1)
    p_row = jnp.where(p_ok, _fill(rung), -1)

    # --- per-group statistics ---------------------------------------------
    sdst = jnp.where(p_ok, p_row, GMAX)
    g_n_iv = jnp.zeros(GMAX + 1, jnp.int32).at[sdst].add(1, mode="drop")[:GMAX]
    g_n_off = jnp.zeros(GMAX + 1, jnp.int32).at[sdst].add(
        p_right - p_left + 1, mode="drop")[:GMAX]

    return np_pieces, p_left, p_right, p_row, g_n_iv, g_n_off


def _numpy_twin_scale(b: np.ndarray, cap: int, count_factor: float,
                      shrink_factor: float):
    """Host mirror of stage A + _merge_scan + stage B (the semantics
    reference for tests).  Takes the raw bucket array (no padding); returns
    (p_left, p_right, p_row, grp_bucket, g_n_iv, g_n_off)."""
    m = b.size
    pos = np.arange(m)
    change = np.concatenate(([True], b[1:] != b[:-1]))
    run_start = np.maximum.accumulate(np.where(change, pos, -1))
    start = change | ((pos - run_start) % cap == 0)
    il = pos[start]
    ir = np.concatenate([il[1:] - 1, [m - 1]])
    ib = b[il]
    ub, r_iv, counts = np.unique(ib, return_inverse=True, return_counts=True)
    R = ub.size
    joins = np.zeros((R, DMAX), np.int64)
    dj = np.abs(np.diff(r_iv))
    lo = np.minimum(r_iv[:-1], r_iv[1:])
    ok = (dj >= 1) & (dj <= DMAX)
    np.add.at(joins, (lo[ok], dj[ok] - 1), 1)
    offs = np.zeros(R, np.int64)
    np.add.at(offs, r_iv, ir - il + 1)
    grp, _ = _merge_scan(counts, offs, joins, count_factor, shrink_factor,
                         cap)
    gfirst = np.concatenate(([True], grp[1:] != grp[:-1]))
    grp_bucket = ub[gfirst]
    g_iv = grp[r_iv]
    ustart = np.concatenate(
        ([True], (g_iv[1:] != g_iv[:-1]) | (il[1:] != ir[:-1] + 1)))
    runL = il[ustart]
    uidx = np.flatnonzero(ustart)
    ends = np.concatenate([uidx[1:] - 1, [il.size - 1]])
    runR = ir[ends]
    rung = g_iv[ustart]
    run_len = runR - runL + 1
    pieces = (run_len + cap - 1) // cap
    rep = np.repeat(np.arange(runL.size), pieces)
    offs = np.concatenate(([0], np.cumsum(pieces)[:-1]))
    within = (np.arange(int(pieces.sum())) - np.repeat(offs, pieces)) * cap
    p_left = runL[rep] + within
    p_right = np.minimum(p_left + cap - 1, runR[rep])
    p_row = rung[rep]
    NG = int(grp.max()) + 1 if R else 0
    g_n_iv = np.zeros(NG, np.int64)
    np.add.at(g_n_iv, p_row, 1)
    g_n_off = np.zeros(NG, np.int64)
    np.add.at(g_n_off, p_row, p_right - p_left + 1)
    return p_left, p_right, p_row, grp_bucket, g_n_iv, g_n_off


@functools.lru_cache(maxsize=4)
def _pipeline_stats_jit():
    import jax
    return jax.jit(_scale_pipeline_stats, static_argnames=("cap", "nbs"))


def _scale_pipeline_stats(b, bucket_lo, n_valid, cap: int, nbs: int):
    """Stats-only pipeline: EXACT per-bucket (offset, capped-interval)
    histograms, no interval materialization.

    The serving path (fly/Pallas probe phase 1 + device verify phase 2 —
    engine/base._device_dense_phase1_flags) reads NO intervals: the probe
    recomputes bucket windows from the raw series and phase 2 gathers data
    windows.  The only index product it consumes is the planner's
    selectivity statistics (plan.determine_query_plan's cost table, fed by
    IndexScale.counts_between_batch).  This pipeline computes those
    statistics exactly at d-grid (unmerged-row) granularity: per bucket, the
    offset count and the number of intervals the cap-RLE would emit
    (IndexNode.java:31's MAXIMUM_DIFF resplit).  The reference's
    variable-width row merge (IndexBuilder.java:308-346) exists to bound
    stored KV row counts; with no stored rows there is nothing to merge, and
    the planner sees FINER (never coarser) selectivity estimates — plans can
    only tighten, and phase 2 is exact regardless.

    Histogramming is SORT-based (one of two equivalent forms; the other is a
    scatter-add histogram): counts come from one sort of the composite key
    (bucket - lo) * 2 + is_interval_start followed by a searchsorted over
    the (host-known, ``nbs``-bounded) bucket span — the narrow query side
    keeps the binary search at ~30 ms.

    b: i32[M] bucket ids, positions >= n_valid carry _SENT; ``nbs`` is a
    static power-of-two >= the bucket span.  Returns (hist_off i32[nbs],
    hist_iv i32[nbs]) indexed by (bucket - bucket_lo).
    """
    import jax
    import jax.numpy as jnp

    M = b.shape[0]
    pos = jnp.arange(M, dtype=jnp.int32)
    valid = pos < n_valid
    change = jnp.concatenate([jnp.ones(1, bool), b[1:] != b[:-1]])
    run_start = _prefix_max(jnp.where(change, pos, -1))
    start = (change | ((pos - run_start) % cap == 0)) & valid
    comp = jnp.where(valid,
                     jnp.clip(b - bucket_lo, 0, nbs - 1) * 2
                     + start.astype(jnp.int32),
                     jnp.int32(2 * nbs))
    sc = jax.lax.sort(comp)
    edges = jnp.arange(2 * nbs + 1, dtype=jnp.int32)
    cnt = jnp.searchsorted(sc, edges, side="left")
    per = (cnt[1:] - cnt[:-1]).reshape(nbs, 2)
    return per[:, 0] + per[:, 1], per[:, 1]


def build_index_device_stats(data, cfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                             stats: Optional[dict] = None,
                             data_dev=None) -> Index:
    """Serving-mode device build: planner statistics only, built entirely on
    the device (one bucket pass + one cummax + two histogram scatter-adds per
    scale; ~8 MB/scale crosses to the host).  The returned IndexScales carry
    keys/row_ptr/cum_* for planning but NO intervals — engines must serve
    phase 1 through the device dense probe (QueryConfig.dense_probe_min_count)
    and phase 2 through the device verify path; any host interval access
    raises.  Use build_index_device (mode='full') when host phase 1 or index
    persistence is needed.  Reference being replaced: IndexBuilder.java:186-348
    at query-serving time, where the index's sole role is phase-1 pruning."""
    import jax
    import jax.numpy as jnp

    data = np.asarray(data)
    n = data.size
    scales = tuple(cfg.scales)
    u = min(scales)
    cap = cfg.maximum_diff - 1
    s = 10.0 ** (cfg.pos_of_d - 1)
    bucket_lo = int(2 * np.floor(float(data.min()) * s)) - 2
    bucket_hi = int(2 * np.floor(float(data.max()) * s)) + 3
    if bucket_hi - bucket_lo >= NB:
        raise ValueError(
            f"mean-bucket range {bucket_hi - bucket_lo} exceeds the device "
            f"histogram capacity {NB}; use the host builder for this data")
    t0 = time.perf_counter()
    if data_dev is None:
        # ``data_dev``: serving deployments already hold the f32 series in
        # HBM (engine.data_dev) — pass it to skip the duplicate upload.
        data_dev = jnp.asarray(data, jnp.float32)
    t_h2d = time.perf_counter() - t0

    # static bucket-span bound, rounded to a power of two so the jit cache
    # stays small across datasets
    nbs = 1 << max(bucket_hi - bucket_lo + 2, 2).bit_length()
    t0 = time.perf_counter()
    pend = {}
    for w in scales:
        b = _bucket_prog(w, u, cfg.pos_of_d)(data_dev)
        pend[w] = _pipeline_stats_jit()(b, jnp.int32(bucket_lo),
                                        jnp.int32(n - w + 1), cap, nbs)
        del b
    hists = jax.device_get(pend)
    t_dev = time.perf_counter() - t0

    t0 = time.perf_counter()
    index: Index = {}
    for w in scales:
        hist_off, hist_iv = (a.astype(np.int64) for a in hists[w])
        present = np.flatnonzero(hist_off)
        buckets = present + bucket_lo
        g_n_off = hist_off[present]
        g_n_iv = hist_iv[present]
        keys = rounding.bucket_to_key(buckets, cfg.pos_of_d)
        row_ptr = np.zeros(present.size + 1, np.int64)
        np.cumsum(g_n_iv, out=row_ptr[1:])
        upper = float(rounding.bucket_to_key(int(buckets[-1]) + 1,
                                             cfg.pos_of_d)) \
            if present.size else float("inf")
        index[w] = IndexScale(
            w=w, n=n, keys=keys, row_ptr=row_ptr, left=None, right=None,
            cum_intervals=np.cumsum(g_n_iv), cum_offsets=np.cumsum(g_n_off),
            mean_upper_bound=upper, stats_only=True)
    t_host = time.perf_counter() - t0
    if stats is not None:
        total = t_h2d + t_dev + t_host
        stats.update(build_seconds=total,
                     mpts_per_second=n * len(scales) / max(total, 1e-9) / 1e6,
                     h2d_seconds=round(t_h2d, 2),
                     device_seconds=round(t_dev, 2),
                     host_group_seconds=round(t_host, 2))
    return index


#: Above this n the builder spills each scale's interval arrays to the host
#: as it goes instead of keeping all scales device-resident: the 5 scales'
#: piece arrays (3 x M x i32 each, ~6 GB at n=1e8) plus one pipeline's
#: transients exceed the chip's HBM and crash the worker.
SPILL_N = 40_000_000


def build_index_device(data, cfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                       stats: Optional[dict] = None,
                       keep_device: bool = True,
                       spill_threshold: int = SPILL_N) -> Index:
    """Build the full index family on the device; host receives row metadata only.

    ``keep_device=True`` leaves the interval arrays device-resident
    (IndexScale materializes host copies lazily); False pulls them eagerly
    (tests / persistence).  Above ``spill_threshold`` points the build runs
    scale-at-a-time and pulls each scale's (device-sliced) piece arrays to the
    host before dispatching the next, bounding peak HBM to one pipeline's
    working set regardless of n.
    """
    import jax
    import jax.numpy as jnp

    data = np.asarray(data)
    n = data.size
    scales = tuple(cfg.scales)
    u = min(scales)
    cap = cfg.maximum_diff - 1
    # bucket range from the HOST data range (no device sync on the hot path)
    s = 10.0 ** (cfg.pos_of_d - 1)
    bucket_lo = int(2 * np.floor(float(data.min()) * s)) - 2
    bucket_hi = int(2 * np.floor(float(data.max()) * s)) + 3
    if bucket_hi - bucket_lo >= NB:
        raise ValueError(
            f"mean-bucket range {bucket_hi - bucket_lo} exceeds the device "
            f"histogram capacity {NB}; use the host builder for this data")
    spill = n > spill_threshold

    t0 = time.perf_counter()
    data_dev = jnp.asarray(data, jnp.float32)
    M = n - u + 1

    def _stage_a(w):
        b = _bucket_prog(w, u, cfg.pos_of_d)(data_dev)
        a = _pipeline_a_jit()(b, jnp.int32(bucket_lo), jnp.int32(n - w + 1),
                              cap)
        del b
        return a

    def _host_merge(meta_a, w):
        """(n_iv, n_rows, row_bucket, row_counts, row_offs, joins) ->
        per-scale rows."""
        n_rows = int(meta_a[1])
        if n_rows > GMAX:
            raise ValueError(f"scale w={w}: {n_rows} rows exceed GMAX")
        row_bucket = meta_a[2][:n_rows].astype(np.int64)
        counts = meta_a[3][:n_rows].astype(np.int64)
        row_offs = meta_a[4][:n_rows].astype(np.int64)
        joins = meta_a[5].reshape(GMAX, DMAX)[:n_rows]
        grp, n_groups = _merge_scan(counts, row_offs, joins,
                                    cfg.merge_count_factor,
                                    cfg.merge_shrink_factor, cap)
        gfirst = np.concatenate(([True], grp[1:] != grp[:-1])) if n_rows \
            else np.zeros(0, bool)
        grp_bucket = row_bucket[gfirst]
        pad = np.zeros(GMAX, np.int32)
        pad[:n_rows] = grp
        max_bucket = int(row_bucket[-1]) if n_rows else 0
        return pad, n_groups, grp_bucket, max_bucket

    def _stage_b(a, grp_pad):
        return _pipeline_b_jit()(a[6], a[7], a[8], a[0],
                                 jnp.asarray(grp_pad), cap)

    # Per scale: stage A on device -> tiny meta pull -> host accumulating
    # merge -> stage B on device.  Non-spill dispatches all A programs before
    # the first pull (they queue back-to-back; the pulls then overlap the
    # later scales' compute); spill runs scale-at-a-time and pulls each
    # scale's (device-sliced) piece arrays before the next dispatch, bounding
    # peak HBM to one pipeline's working set regardless of n.
    t_dev = t_d2h = t_host = 0.0
    rowmeta = {}
    pending_b = {}
    spilled = {}
    if not spill:
        pend_a = {w: _stage_a(w) for w in scales}
        meta_a = jax.device_get({w: a[:6] for w, a in pend_a.items()})
        for w in scales:
            t1 = time.perf_counter()
            rowmeta[w] = _host_merge(meta_a[w], w)
            t_host += time.perf_counter() - t1
            pending_b[w] = _stage_b(pend_a[w], rowmeta[w][0])
            del pend_a[w]
        meta_b = jax.device_get({w: (o[0], o[4][:GMAX], o[5][:GMAX])
                                 for w, o in pending_b.items()})
    else:
        meta_b = {}
        for w in scales:
            t1 = time.perf_counter()
            a = _stage_a(w)
            ma = jax.device_get(a[:6])
            t2 = time.perf_counter()
            t_dev += t2 - t1
            rowmeta[w] = _host_merge(ma, w)
            t3 = time.perf_counter()
            t_host += t3 - t2
            ob = _stage_b(a, rowmeta[w][0])
            del a
            mb = jax.device_get((ob[0], ob[4][:GMAX], ob[5][:GMAX]))
            t4 = time.perf_counter()
            t_dev += t4 - t3
            meta_b[w] = mb
            np_pieces = int(mb[0])
            k = min(M, -(-max(np_pieces, 1) // _SLICE_Q) * _SLICE_Q)
            sl = _slice_prog(M, k)(ob[1], ob[2], ob[3])
            pieces_w = jax.device_get(sl)
            del sl, ob
            t_d2h += time.perf_counter() - t4
            spilled[w] = tuple(p[:np_pieces] for p in pieces_w)

    index: Index = {}
    for w in scales:
        np_pieces = int(meta_b[w][0])
        grp_pad, n_groups, grp_bucket, max_bucket = rowmeta[w]
        g_n_iv = meta_b[w][1][:n_groups].astype(np.int64)
        g_n_off = meta_b[w][2][:n_groups].astype(np.int64)
        keys = rounding.bucket_to_key(grp_bucket, cfg.pos_of_d)
        row_ptr = np.zeros(n_groups + 1, np.int64)
        np.cumsum(g_n_iv, out=row_ptr[1:])
        upper = float(rounding.bucket_to_key(max_bucket + 1, cfg.pos_of_d)) \
            if n_groups else float("inf")
        sc = IndexScale(
            w=w, n=n, keys=keys, row_ptr=row_ptr,
            left=None, right=None,
            cum_intervals=np.cumsum(g_n_iv), cum_offsets=np.cumsum(g_n_off),
            mean_upper_bound=upper,
            dev_pos_view=None if spill
            else (pending_b[w][1], pending_b[w][2], pending_b[w][3],
                  np_pieces),
        )
        if spill:
            t1 = time.perf_counter()
            sc.set_pos_arrays(*spilled[w])
            t_host += time.perf_counter() - t1
        elif not keep_device:
            sc.materialize_host()
        index[w] = sc
        logger.debug("device build w=%d: %d pieces, %d rows", w, np_pieces,
                     n_groups)
    if stats is not None:
        total = time.perf_counter() - t0
        stats.update(build_seconds=total,
                     mpts_per_second=n * len(scales) / max(total, 1e-9) / 1e6)
        if spill:
            stats.update(device_seconds=round(t_dev, 2),
                         d2h_seconds=round(t_d2h, 2),
                         host_group_seconds=round(t_host, 2))
    return index
